"""The plain reference the benchmark judges the program by: plain PyTorch
and NumPy, importing nothing of the program or of JAX."""
