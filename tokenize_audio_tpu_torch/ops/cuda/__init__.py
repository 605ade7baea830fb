"""CUDA C++ kernels for Hopper (sources under tokenize_audio_tpu_torch/csrc/),
built with nvcc at first use and bound with ctypes (see _build.py)."""
