"""Layout conversion between the JAX package's pytrees and the port's.

The JAX model stacks its layers for ``lax.scan``: every leaf of
``params["unit"]["pos{p}"]`` has a leading ``reps`` axis, layer
``r * len(unit) + p``; a remainder tail lives under ``params["rem"]``.
The port keeps one dict per layer. Leaves are copied 1:1, dtype included
(no transposes: both store projections ``(d_in, d_out)``; an RWKV-6
layer's float32 ``w_base`` and ``u``, a Mamba2 layer's ``A_log``, ``D`` and
``dt_bias`` and an MoE router stay float32; expert stacks ``(E, d, f)``
keep their expert axis). Zamba2's shared attention block has no entry at
its unit positions in either tree: both keep it once, at the top-level
``shared_attn``, and the port's hybrid layers are empty dicts. Caches go
by the names each layer's kind has (``transformer.cache_slots``; hybrid
positions keep k/v caches of their own in both). Top-level leaves that
only some configs have (``lm_head``, the stub frontend's
``frontend_proj``, ``shared_attn``) go both ways as they are. Inputs are numpy arrays, so
the port never touches a jax array; tests pass
``jax.tree.map(np.asarray, tree)``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Tuple

import numpy as np
import torch

from repro_torch.config import AttentionKind, BlockKind, ModelConfig
from repro_torch.models.transformer import Caches, Params, cache_slots, resolve_device
from repro_torch.tree import tree_map


def find_unit(cfg: ModelConfig) -> Tuple[List[Tuple[BlockKind, AttentionKind]], int, int]:
    """Smallest repeating unit of (block kind, attention kind), as the JAX
    model scans it. Returns (unit, num_repeats, num_remainder)."""
    ext = [(k, cfg.attention_kind_at(i)) for i, k in enumerate(cfg.layer_pattern)]
    n = len(ext)
    for u in range(1, n + 1):
        unit = ext[:u]
        reps = n // u
        if all(ext[i] == unit[i % u] for i in range(reps * u)):
            rem = n - reps * u
            if all(ext[reps * u + j] == unit[j] for j in range(rem)):
                return unit, reps, rem
    return ext, 1, 0


def _layer_sources(cfg: ModelConfig) -> List[Tuple[str, str, Any]]:
    """For layer i: ("unit", "pos{p}", rep) or ("rem", "rem{j}", None), where
    the JAX tree keeps its caches (and its params, unless it is a hybrid
    shared-attention position)."""
    unit, reps, rem = find_unit(cfg)
    out = [("unit", f"pos{p}", r) for r in range(reps) for p in range(len(unit))]
    out += [("rem", f"rem{j}", None) for j in range(rem)]
    return out


# Leaves outside the layers that only some configs have: the untied LM head,
# the stub frontend's projection and Zamba2's shared attention block.
TOP_LEVEL = ("lm_head", "frontend_proj", "shared_attn")


def _to_torch(tree: Any, device, index=None) -> Any:
    if isinstance(tree, dict):
        return {k: _to_torch(v, device, index) for k, v in tree.items()}
    a = np.asarray(tree)
    if index is not None:
        a = a[index]
    return torch.from_numpy(np.array(a)).to(device)  # a writable copy


def params_from_jax_numpy(cfg: ModelConfig, tree: Dict[str, Any], device=None) -> Params:
    """The JAX ``Model.init`` pytree (numpy leaves) as the port's params, on
    ``device`` (the card unless the caller asks for another)."""
    device = resolve_device(device)
    params: Params = {
        "embed": _to_torch(tree["embed"], device),
        "final_norm": _to_torch(tree["final_norm"], device),
    }
    for name in TOP_LEVEL:
        if name in tree:
            params[name] = _to_torch(tree[name], device)
    params["layers"] = [
        {} if kind == BlockKind.HYBRID_SHARED_ATTN else _to_torch(tree[group][key], device, rep)
        for kind, (group, key, rep) in zip(cfg.layer_pattern, _layer_sources(cfg))]
    return params


def _to_numpy(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def params_to_jax_numpy(cfg: ModelConfig, params: Params) -> Dict[str, Any]:
    """Inverse of ``params_from_jax_numpy``: numpy leaves in the JAX layout
    (``params_to_scan``: layers stacked per unit position, the tail under
    ``rem``). numpy has no bfloat16, so bf16 leaves come back as float32."""
    return _to_numpy(params_to_scan(cfg, params))


def caches_from_jax_numpy(cfg: ModelConfig, tree: Dict[str, Any], device=None) -> Caches:
    """JAX caches ``{"unit": {"pos{p}": {name: ...}}, "rem": ...}`` -> the
    port's per-name lists, on ``device`` (the card unless the caller asks
    for another)."""
    device = resolve_device(device)
    out: Caches = {}
    for group, key, rep in _layer_sources(cfg):
        for name, leaf in tree[group][key].items():
            a = np.asarray(leaf)
            if rep is not None:
                a = a[rep]
            out.setdefault(name, []).append(torch.from_numpy(np.array(a)).to(device))
    return out


def caches_to_jax_numpy(cfg: ModelConfig, caches: Caches) -> Dict[str, Any]:
    """Inverse of ``caches_from_jax_numpy``: numpy leaves in the JAX layout."""
    unit, reps, rem = find_unit(cfg)
    slots = cache_slots(cfg)
    sources = _layer_sources(cfg)

    def leaf(i: int, name: str) -> np.ndarray:
        return caches[name][slots[i][1]].detach().cpu().float().numpy()

    tree: Dict[str, Any] = {"unit": {}, "rem": {}}
    for p in range(len(unit)):
        layers = [i for i, (g, k, _) in enumerate(sources) if g == "unit" and k == f"pos{p}"]
        tree["unit"][f"pos{p}"] = {
            name: np.stack([leaf(i, name) for i in layers]) for name in slots[layers[0]][0]
        }
    for j in range(rem):
        i = reps * len(unit) + j
        tree["rem"][f"rem{j}"] = {name: leaf(i, name) for name in slots[i][0]}
    return tree


def params_to_scan(cfg: ModelConfig, params: Params,
                   stack: Callable[[List[torch.Tensor]], torch.Tensor] = torch.stack
                   ) -> Dict[str, Any]:
    """The port's params in the JAX layout, as tensors: the layers that share
    a unit position stacked on a leading ``reps`` axis (``stack``; a copy on
    a device, free on the meta device), the tail under ``rem``, top-level
    leaves as they are. A tenant-stacked cohort's leaves keep their tenant
    axis first: (R, reps, ...) with ``stack=lambda ts: torch.stack(ts, 1)``."""
    unit, reps, rem = find_unit(cfg)
    layers = params["layers"]
    tree: Dict[str, Any] = {name: params[name]
                            for name in ("embed", "final_norm", *TOP_LEVEL) if name in params}

    def stacked(trees):
        if isinstance(trees[0], dict):
            return {k: stacked([t[k] for t in trees]) for k in trees[0]}
        return stack(trees)

    shared = BlockKind.HYBRID_SHARED_ATTN
    tree["unit"] = {f"pos{p}": stacked([layers[r * len(unit) + p] for r in range(reps)])
                    for p in range(len(unit)) if unit[p][0] != shared}
    tree["rem"] = {f"rem{j}": layers[reps * len(unit) + j] for j in range(rem)
                   if unit[j][0] != shared}
    return tree


def params_from_scan(cfg: ModelConfig, tree: Dict[str, Any], tenant_axis: bool = False) -> Params:
    """Inverse of ``params_to_scan`` without a copy: each layer's leaves are
    views into its stack (``stack[rep]``, or ``stack[:, rep]`` past a
    leading tenant axis), so gradients and in-place updates reach the
    stacks."""
    params: Params = {name: tree[name]
                      for name in ("embed", "final_norm", *TOP_LEVEL) if name in tree}

    def pick(rep):
        return (lambda a: a[:, rep]) if tenant_axis else (lambda a: a[rep])

    params["layers"] = [
        {} if kind == BlockKind.HYBRID_SHARED_ATTN
        else tree[group][key] if rep is None else tree_map(pick(rep), tree[group][key])
        for kind, (group, key, rep) in zip(cfg.layer_pattern, _layer_sources(cfg))]
    return params
