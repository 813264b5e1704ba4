"""Device meshes as counts: the shapes the sharding arithmetic reads.

The JAX package builds ``jax.sharding.Mesh``es of placeholder devices
(``make_production_mesh``: one v5e pod of 256 chips, or two). The port
runs on one card: multi-GPU is out of scope for it (``ROADMAP.md``'s
north star), and a mesh here is a count, not a machine. ``Mesh`` holds
only what the reference's sharding rules read, ``axis_names`` and
``shape[axis]`` (its own tests use such a stub, ``tests/test_sharding.py``),
plus ``size``; ``distributed.sharding.shard_shape`` turns a spec into each
device's shard of an array under it.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.config.runtime import MeshConfig


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A device-less mesh: axis names and their sizes, in order."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    def __post_init__(self) -> None:
        if len(self.axis_names) != len(self.sizes) or any(s < 1 for s in self.sizes):
            raise ValueError(f"mesh axes {self.axis_names} and sizes {self.sizes} must pair "
                             "up, each size >= 1")

    @property
    def shape(self) -> Dict[str, int]:
        """Axis name -> size, in axis order (as ``jax.sharding.Mesh.shape``)."""
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    @staticmethod
    def from_config(mc: MeshConfig) -> "Mesh":
        return Mesh(tuple(mc.axis_names), tuple(mc.shape))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production meshes: (data=16, model=16) = 256 devices;
    multi-pod (pod=2, data=16, model=16) = 512."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_host_mesh(model: int = 1) -> Mesh:
    """(data=1, model=``model``); with ``model=1`` the one card the port runs on."""
    return Mesh(("data", "model"), (1, model))
