"""GEMM, attention and WKV6 kernels: hand-written CUDA for Hopper, plain
PyTorch versions beside them (``ref``), and the device-routed dispatch
layer (``ops``).

CUDA sources live in ``csrc/``; ``_build`` compiles them with ``nvcc`` at
first use. Nothing is built or loaded at import.
"""
