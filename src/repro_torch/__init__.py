"""PyTorch/CUDA port of the space-time scheduling system, for NVIDIA Hopper.

A package of its own beside the JAX reference ``repro``: it imports torch,
numpy and the standard library only. Module names follow ``repro`` so each
counterpart is easy to find. Entry points (``build_model``, ``Model``,
``MultiTenantEngine``) run on ``cuda`` unless the caller passes
``device="cpu"``.
"""
