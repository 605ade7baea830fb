"""The benchmark's own code: the manifest, traffic, weights, operation
counts, tracing, the correctness check and the runner that ties them.

Nothing here imports JAX or the JAX package; the program under test,
``tokenize_audio_tpu_torch``, is imported only by the runner and the
drivers, never by ``port_bench/reference``.
"""
