"""Activation sharding constraints (MaxText-style logical annotations).

The JAX package's model code calls ``constrain(x, "batch", None, "model")``
with LOGICAL axis names, and its launchers activate a mesh with
``use_mesh``; ``constrain`` then hands ``with_sharding_constraint`` the
physical spec ``constraint_spec`` computes here. The port runs on one
card, which has no partitioner: ``constrain`` returns its input unchanged,
and the port's models call no constraint at all (they would do nothing).
``constraint_spec`` keeps the rule, so the spec the reference would
impose can be read and held against it.

Logical -> physical:
    "batch"  -> ("pod", "data") when present, else ("data",)
    "model"  -> ("model",)
    "data"   -> ("data",)   (sequence sharding for batch=1 long-context)
Axes that don't divide the corresponding dim are dropped rather than
producing uneven shardings.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Optional, Sequence, Tuple

_state = threading.local()


def active_mesh():
    return getattr(_state, "mesh", None)


def tp_activations_enabled() -> bool:
    return getattr(_state, "tp_acts", True)


@contextlib.contextmanager
def use_mesh(mesh, tp_activations: bool = True):
    """Activate a mesh for activation constraints.

    tp_activations: when False, "model"-axis constraints on activations
    become no-ops (weights may still be model/data-sharded for storage; the
    reference's partitioner then gathers weights per layer instead of
    planting tensor-parallel activation collectives). Expert-parallel
    constraints pass force=True and are unaffected.
    """
    prev = active_mesh()
    prev_tp = tp_activations_enabled()
    _state.mesh = mesh
    _state.tp_acts = tp_activations
    try:
        yield mesh
    finally:
        _state.mesh = prev
        _state.tp_acts = prev_tp


def _physical(mesh, logical) -> Optional[tuple]:
    if logical is None:
        return None
    if logical == "batch":
        axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
        return axes or None
    if logical in mesh.axis_names:
        return (logical,)
    return None


def constraint_spec(shape: Sequence[int], *logical_axes, force: bool = False) -> Optional[Tuple]:
    """The spec the reference's ``constrain`` would hand to
    ``with_sharding_constraint`` for an array of ``shape`` under the active
    mesh (None when no mesh is active). force=True keeps "model"-axis
    constraints even when tp_activations is off."""
    mesh = active_mesh()
    if mesh is None:
        return None
    if len(logical_axes) != len(shape):
        raise ValueError(f"spec rank {len(logical_axes)} != array rank {len(shape)}")
    if not force and not tp_activations_enabled():
        logical_axes = tuple(None if a == "model" else a for a in logical_axes)
    spec = []
    used: set = set()
    for dim, logical in zip(shape, logical_axes):
        axes = _physical(mesh, logical)
        if axes is None or any(a in used for a in axes):
            spec.append(None)
            continue
        size = math.prod(mesh.shape[a] for a in axes)
        if dim % size == 0 and dim >= size:
            spec.append(axes if len(axes) > 1 else axes[0])
            used.update(axes)
        elif len(axes) > 1:
            # try the trailing axis alone (e.g. "data" without "pod")
            a = axes[-1]
            if dim % mesh.shape[a] == 0 and dim >= mesh.shape[a]:
                spec.append(a)
                used.add(a)
            else:
                spec.append(None)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, *logical_axes, force: bool = False):
    """One card has no partitioner: returns ``x`` unchanged (checking, under
    an active mesh, that the logical spec has x's rank, as the reference
    does)."""
    constraint_spec(tuple(x.shape), *logical_axes, force=force)
    return x
