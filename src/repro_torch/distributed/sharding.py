"""Sharding rule tables for params, inputs and caches, as spec arithmetic.

The JAX package's ``repro.distributed.sharding`` over device-less meshes
(``launch.mesh.Mesh``): the same rules reach the same specs, and
``shard_shape`` stands where the reference's ``to_shardings`` builds
``NamedSharding``s: one card has no partitioner, so a spec here describes
how the reference would split an array, and what each device would hold.

A spec is a plain tuple, one entry per dim: ``None`` (replicated), an axis
name, or a tuple of axis names (the product of their sizes). ``()`` is a
scalar's spec.

Strategy (single-pod mesh ``(data=16, model=16)``; multi-pod adds a leading
``pod=2`` axis used for data parallelism and ZeRO-style optimizer-state
sharding):

* **Weights: FSDP-style 2D sharding.** Every >=2-D parameter leaf greedily
  assigns the ``model`` axis to its largest divisible dim, then the ``data``
  axis to the largest remaining divisible dim. 1-D leaves shard over
  ``model`` when divisible, else replicate. Leaves of 3 or more dims never
  shard dim 0 (the reference's scanned layer stacks, ``reps`` first).
* **Batch-bearing activations** shard batch over ``(pod, data)`` when
  divisible, falling back to ``data`` then replication.
* **Decode caches**: batch over ``data``; KV heads over ``model`` when
  divisible, else the sequence; for global_batch=1 long-context decode the
  *sequence* axis takes ``data`` instead (sequence-sharded KV cache).
* **Optimizer state (mu/nu)** inherits the param spec, plus, multi-pod, the
  ``pod`` axis on the largest still-unsharded divisible dim (ZeRO-1 across
  pods).

Params and optimizer moments are specced in the reference's scan layout
(``models.convert.params_to_scan``), where every layer leaf is a stack
over the layers that share its unit position: the rules above read those
stacked shapes. Caches are specced in the port's own layout, one tensor per
layer (``cache_specs``); the reference's unit caches carry a ``reps`` axis
its rule skips, so both reach the same spec on every layer.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional, Sequence, Tuple

Pytree = Any
Spec = Tuple[Any, ...]


def _is_record(tree: Any) -> bool:
    """A named tuple (the optimizer state) is a container; a plain tuple is
    a leaf (a spec)."""
    return isinstance(tree, tuple) and hasattr(tree, "_fields")


def spec_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """Map ``fn`` over the leaves of nested dicts, lists and named tuples; a
    plain tuple is a leaf (a spec)."""
    if isinstance(tree, dict):
        return {k: spec_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [spec_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    if _is_record(tree):
        return type(tree)(*(spec_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)))
    return fn(tree, *rest)


def spec_leaves(tree: Any) -> list:
    """The leaves of nested dicts, lists and named tuples, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in spec_leaves(v)]
    if isinstance(tree, list) or _is_record(tree):
        return [x for v in tree for x in spec_leaves(v)]
    return [tree]


# --------------------------------------------------------------------- helpers
def data_axes(mesh) -> Tuple[str, ...]:
    """Axes usable for batch data parallelism, biggest grouping first."""
    names = mesh.axis_names
    return tuple(a for a in ("pod", "data") if a in names)


def _axis_size(mesh, axis) -> int:
    if isinstance(axis, tuple):
        return math.prod(mesh.shape[a] for a in axis)
    return mesh.shape[axis]


def choose_spec(
    shape: Sequence[int],
    mesh,
    axes_priority: Sequence[Any] = ("model", "data"),
    taken: Optional[Dict[int, Any]] = None,
) -> Spec:
    """Greedy divisible assignment: each axis (in priority order) goes to the
    largest not-yet-sharded dim it divides evenly."""
    assign: Dict[int, Any] = dict(taken or {})
    for axis in axes_priority:
        if axis not in mesh.axis_names and not isinstance(axis, tuple):
            continue
        size = _axis_size(mesh, axis)
        best, best_dim = None, 0
        for d, n in enumerate(shape):
            if d in assign:
                continue
            if n % size == 0 and n // size > 0 and n > best_dim:
                best, best_dim = d, n
        if best is not None:
            assign[best] = axis
    return tuple(assign.get(d) for d in range(len(shape)))


def _batch_spec(mesh, batch: int) -> Optional[Any]:
    """Pick the widest divisible data-parallel grouping for a batch dim."""
    dp = data_axes(mesh)
    for cand in (dp, dp[-1:] if dp else ()):
        if not cand:
            continue
        axes = cand if len(cand) > 1 else cand[0]
        if batch % _axis_size(mesh, axes) == 0:
            return axes
    return None


def _itemsize(leaf) -> int:
    return leaf.dtype.itemsize


# --------------------------------------------------------------------- params
def param_specs(params_shape: Pytree, mesh, policy: str = "fsdp") -> Pytree:
    """Weight sharding specs for a tree of leaves with ``shape`` and ``dtype``
    (meta tensors), in the reference's scan layout.

    policy:
      "fsdp"      2D (model, data): minimal memory, pays weight all-gathers
                  every step.
      "tp"        model-axis only, replicated across data: zero weight
                  gathers (activation all-reduces instead).
      "replicate" no weight sharding at all: zero weight collectives.
      "auto"      per-model choice by replicated-weight footprint:
                  <= 4 GiB -> replicate; <= 4 GiB model-sharded -> tp;
                  else fsdp.
    """
    if policy == "auto":
        total = sum(math.prod(l.shape) * _itemsize(l) for l in spec_leaves(params_shape))
        if total <= 4 * 2**30:
            policy = "replicate"
        elif total / mesh.shape.get("model", 1) <= 4 * 2**30:
            policy = "tp"
        else:
            policy = "fsdp"

    axes = {
        "fsdp": ("model", "data"),
        "tp": ("model",),
        "replicate": (),
    }[policy]

    def rule(leaf) -> Spec:
        shape = tuple(leaf.shape)
        if not axes:
            return (None,) * len(shape)
        if len(shape) <= 1:
            return choose_spec(shape, mesh, axes[:1])
        if len(shape) == 2:
            return choose_spec(shape, mesh, axes)
        # stacked leaves (reps/experts leading): never shard the stack axis
        # of scanned units; remaining dims get model/data greedily.
        return choose_spec(shape, mesh, axes, taken={0: None})

    return spec_map(rule, params_shape)


def opt_state_specs(params_shape: Pytree, mesh, policy: str = "fsdp") -> Pytree:
    """mu/nu: param spec + pod axis on the largest remaining dim (ZeRO-1)."""
    base = param_specs(params_shape, mesh, policy)
    if "pod" not in mesh.axis_names:
        return base

    def widen(leaf, spec: Spec) -> Spec:
        shape = tuple(leaf.shape)
        taken = {d: a for d, a in enumerate(spec) if a is not None}
        if len(shape) >= 3:
            taken.setdefault(0, None)
        return choose_spec(shape, mesh, ("pod",), taken=taken)

    return spec_map(widen, params_shape, base)


# --------------------------------------------------------------------- caches
def cache_specs(caches_shape: Pytree, mesh, batch: int) -> Pytree:
    """Specs for the port's decode caches: ``{name: [one leaf per layer]}``
    (``models.transformer``'s layout, no tenant axis), by name:

        k/v      (B, Hkv, S, D)   attention KV
        conv_*   (B, W, C)        mamba conv state
        ssm      (B, H, P, N)     mamba SSM state
        wkv      (B, H, N, N)     rwkv state
        shift_*  (B, D)           rwkv token-shift state

    The reference's rule on its unit caches skips their leading ``reps``
    axis, so the spec of each layer's leaf here is the reference's with
    that entry (always None) left out."""
    bspec = _batch_spec(mesh, batch)

    def rule(name: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        spec: list = [None] * len(shape)

        def set_if_div(dim: int, axis) -> bool:
            size = _axis_size(mesh, axis)
            if shape[dim] % size == 0 and spec[dim] is None:
                spec[dim] = axis
                return True
            return False

        def batch_fits() -> bool:
            return bspec is not None and shape[0] % _axis_size(mesh, bspec) == 0

        if name in ("k", "v"):
            # (B, Hkv, S, D). Never shard head_dim D (a sharded contraction
            # would all-reduce every score tensor); when KV heads don't
            # divide the model axis, shard the sequence instead.
            if batch_fits():
                spec[0] = bspec
                set_if_div(1, "model") or set_if_div(2, "model")
            else:
                # batch=1 long-context: sequence-sharded cache
                set_if_div(2, "data")
                set_if_div(1, "model") or set_if_div(2, "model")
        elif name.startswith("conv"):
            if batch_fits():
                spec[0] = bspec
            set_if_div(2, "model")
        elif name in ("ssm", "wkv"):
            if batch_fits():
                spec[0] = bspec
            set_if_div(1, "model")
        elif name.startswith("shift"):
            if batch_fits():
                spec[0] = bspec
            set_if_div(1, "model")
        return tuple(spec)

    return {name: [rule(name, leaf) for leaf in leaves] for name, leaves in caches_shape.items()}


# --------------------------------------------------------------------- inputs
def input_specs_shardings(mesh, batch: int, kind: str) -> Dict[str, Spec]:
    """Specs for token-level step inputs."""
    del kind
    bspec = _batch_spec(mesh, batch)
    return {
        "tokens": (bspec, None),
        "labels": (bspec, None),
        "token": (bspec,),
        "lengths": (bspec,),
        "prefix_embeds": (bspec, None, None),
    }


# --------------------------------------------------------------------- shards
def shard_shape(shape: Sequence[int], spec: Spec, mesh) -> Tuple[int, ...]:
    """Each device's shard of an array of ``shape`` under ``spec``: every
    sharded dim divided by the product of its axes' sizes, rounded up (as
    GSPMD pads an uneven split)."""
    if len(spec) != len(shape):
        raise ValueError(f"spec {spec} has {len(spec)} entries for a shape of rank {len(shape)}")
    return tuple(n if a is None else -(-n // _axis_size(mesh, a)) for n, a in zip(shape, spec))


def shard_bytes(tree: Pytree, specs: Pytree, mesh) -> int:
    """Bytes one device holds of every leaf of ``tree`` (leaves with
    ``shape`` and ``dtype``) under ``specs`` (the same structure)."""
    leaves, spec_list = spec_leaves(tree), spec_leaves(specs)
    if len(leaves) != len(spec_list):
        raise ValueError(f"{len(leaves)} leaves against {len(spec_list)} specs")
    return sum(math.prod(shard_shape(tuple(l.shape), s, mesh)) * _itemsize(l)
               for l, s in zip(leaves, spec_list))
