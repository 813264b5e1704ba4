"""Architectures the port runs; each module registers its config on import."""

from repro_torch.configs import rwkv6_1_6b, stablelm_1_6b  # noqa: F401

PORTED_ARCHS = ("stablelm-1.6b", "rwkv6-1.6b")
