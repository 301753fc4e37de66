"""spectre_tpu_torch: the PyTorch + CUDA (Hopper) port of spectre_tpu.

It mirrors the JAX package's module names (configs, ops, models, serving,
repl) and imports ``torch``, never ``jax``. Every TPU kernel on its path is a
hand-written CUDA kernel in ``csrc/`` with a plain PyTorch version beside it
(``ops/kernels``).
"""
