"""AdamW over a whole parameter tree in two launches (CUDA).

Wrapper of ``csrc/adamw.cu``. It replaces no Pallas kernel: the JAX
package's optimizer is jnp, ``adamw_update``
(``src/repro/training/optimizer.py:41``), which XLA fuses inside the jitted
train step. Its plain versions are ``ref.adamw_norm`` and
``ref.adamw_update``; ``ops.adamw_norm`` and ``ops.adamw_update`` pick
between them and this module by the device of the tensors. A step is:

- ``norm(grads)``: (a) the float32 global L2 norm of the gradients, one
  launch (``norm_counter``): a fixed slot a tile, summed in a fixed order by
  the last block, so every run gives the same bits;
- the scale, step and bias corrections, a few scalar torch ops
  (``training.optimizer.update_scalars``);
- ``update(...)``: (b) every param, first and second moment updated in
  place, one launch (``counter``), each element read and written once in the
  plain version's order and rounding, so that given the same scalars the
  result equals ``ref.adamw_update``'s bit for bit.

The leaves travel by value in the launch's parameters, a pack of at most
``MAX_LEAVES`` (the multi-tensor-apply pattern): a CUDA graph records them,
and the scale, bias corrections and lr are read from device memory. The
grouping and tiling are fixed before any launch by ``plan(numels, dtypes)``:
leaves grouped by dtype (bf16 first, then float32, each in tree order), each
cut into tiles of ``TILE`` elements (a block each), packed ``MAX_LEAVES`` at
a time (one launch of each kernel a pack; both real trees take one).
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import math
from typing import Sequence, Tuple

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()       # (b), the update
norm_counter = _build.OpCounter()  # (a), the norm
VARIANT = "multi_tensor"  # the one kernel of each: leaves by value, a block a tile
THREADS = 256
TILE = THREADS * 8 * 4    # elements a block: 8 a thread and vector, 4 vectors
MAX_LEAVES = 640          # leaves a pack (a launch) holds
LEAF_BYTES = 44           # a leaf in the pack: 4 pointers, its size, its first tile (int32)
PACK_HEADER_BYTES = 16
PARAM_LIMIT_BYTES = 32764  # kernel parameters a launch may take (CUDA 12.1+)
# the update kernel's parameters: the pack, 4 scalar pointers, 6 floats
PARAM_BYTES = PACK_HEADER_BYTES + MAX_LEAVES * LEAF_BYTES + 4 * 8 + 6 * 4
GROUPS = (torch.bfloat16, torch.float32)  # param dtypes the kernels take, in pack order
_F32_EPS = 2.0 ** -24  # float32's unit roundoff


@dataclasses.dataclass(frozen=True)
class Pack:
    """One launch's leaves: indices into the tree's leaves (bf16 ones
    first), the first float32 one's position, and each leaf's first tile,
    counted over the whole plan."""

    leaves: Tuple[int, ...]
    first_f32: int
    tile0: Tuple[int, ...]
    tiles: int


@dataclasses.dataclass(frozen=True)
class Plan:
    packs: Tuple[Pack, ...]
    tiles: int  # over every pack: the norm pass's slots


def tiles_of(numel: int) -> int:
    return -(-numel // TILE)


@functools.lru_cache(maxsize=64)
def _plan(numels: Tuple[int, ...], dtypes: Tuple[torch.dtype, ...]) -> Plan:
    if len(numels) != len(dtypes):
        raise ValueError(f"adamw.plan: {len(numels)} sizes for {len(dtypes)} dtypes")
    bad = sorted({str(d) for d in dtypes if d not in GROUPS})
    if bad:
        raise TypeError(f"adamw.plan: the kernels take {GROUPS}, not {bad}")
    if any(n < 0 for n in numels):
        raise ValueError("adamw.plan: a negative size")
    order = [i for dt in GROUPS for i, d in enumerate(dtypes) if d == dt and numels[i] > 0]
    packs, tile = [], 0
    for start in range(0, len(order), MAX_LEAVES):
        leaves = order[start:start + MAX_LEAVES]
        first = tile
        tile0 = []
        for i in leaves:
            tile0.append(tile)
            tile += tiles_of(numels[i])
        packs.append(Pack(tuple(leaves), sum(dtypes[i] == torch.bfloat16 for i in leaves),
                          tuple(tile0), tile - first))
    return Plan(tuple(packs), tile)


def plan(numels: Sequence[int], dtypes: Sequence[torch.dtype]) -> Plan:
    """The launches for a tree of leaves of ``numels`` elements with params
    of ``dtypes`` (bf16 or float32): packs of at most ``MAX_LEAVES``
    non-empty leaves, grouped by dtype, each leaf cut into ``TILE``-element
    tiles. Empty leaves have nothing to update and are left out."""
    return _plan(tuple(int(n) for n in numels), tuple(dtypes))


def norm_rtol(tiles: int) -> float:
    """A bound on the norm kernel's relative error for a plan of ``tiles``
    tiles: the longest chain of float32 additions an element's square goes
    through (32 in a thread's share of a tile, 8 in the block's tree,
    ceil(tiles / THREADS) in the last block's thread, 8 in its tree), each
    at most float32's unit roundoff for these nonnegative terms, halved by
    the square root, plus the root's own rounding."""
    depth = TILE // THREADS + 8 + -(-tiles // THREADS) + 8
    return depth * _F32_EPS / 2 + _F32_EPS


def _check_leaf(t: torch.Tensor, what: str, dtype: torch.dtype, device: torch.device,
                numel: int) -> None:
    _build.check_tensor(t, what, dtype)
    if t.device != device or t.numel() != numel:
        raise ValueError(f"{what}: {t.numel()} elements on {t.device}, expected {numel} on "
                         f"{device}")


def _check_scalar(t: torch.Tensor, what: str, device: torch.device) -> None:
    if not isinstance(t, torch.Tensor) or t.dtype != torch.float32 or t.numel() != 1 \
            or t.device != device:
        raise ValueError(f"adamw.update: {what} must be a float32 tensor of one element on "
                         f"{device}")


def _launch(kind: int, plan_: Plan, ptrs: Sequence[Tuple[int, int, int, int]],
            numels: Sequence[int], like: torch.Tensor, work: int = 0, gnorm: int = 0,
            scalars: Sequence[int] = (0, 0, 0, 0), consts: Sequence[float] = (0.0,) * 6) -> None:
    """One launch of kernel ``kind`` (0 the norm, 1 the update) a pack, on
    ``like``'s card and current stream."""
    lib = _build.load("adamw")
    stream = _build.stream_of(like)
    done = work + 4 * plan_.tiles if work else 0  # the counter after the slots
    for pk in plan_.packs:
        n = len(pk.leaves)
        flat = (ctypes.c_longlong * (4 * n))(*(a for i in pk.leaves for a in ptrs[i]))
        sizes = (ctypes.c_longlong * n)(*(numels[i] for i in pk.leaves))
        tile0 = (ctypes.c_longlong * n)(*pk.tile0)
        with torch.cuda.device(like.device):
            status = lib.repro_adamw(
                kind, n, pk.first_f32, pk.tile0[0], pk.tiles, plan_.tiles,
                ctypes.addressof(flat), ctypes.addressof(sizes), ctypes.addressof(tile0),
                work or None, done or None, gnorm or None, *(s or None for s in scalars),
                *consts, stream)
        _build.check_status(lib, "adamw", status)
        (norm_counter if kind == 0 else counter).launched(VARIANT)


def norm(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The float32 global L2 norm of ``grads`` (contiguous, 16-byte aligned
    bf16 or float32 tensors on one card), as a 0-dim tensor there. One
    launch a pack; raises on anything the kernel does not take."""
    if not grads:
        raise ValueError("adamw.norm: no gradients")
    device = grads[0].device
    _build.check_device(grads[0])
    for i, g in enumerate(grads):
        _check_leaf(g, f"adamw.norm: gradient {i}", g.dtype, device, g.numel())
    numels = [g.numel() for g in grads]
    p = plan(numels, [g.dtype for g in grads])
    out = torch.empty((), dtype=torch.float32, device=device)
    if not p.packs:
        return out.zero_()
    work = torch.empty(p.tiles + 1, dtype=torch.float32, device=device)  # slots, counter
    _launch(0, p, [(g.data_ptr(), 0, 0, 0) for g in grads], numels, out,
            work=work.data_ptr(), gnorm=out.data_ptr())
    return out


def update(
    params: Sequence[torch.Tensor],
    grads: Sequence[torch.Tensor],
    mus: Sequence[torch.Tensor],
    nus: Sequence[torch.Tensor],
    scale: torch.Tensor,
    bc1: torch.Tensor,
    bc2: torch.Tensor,
    lr: torch.Tensor,
    *,
    b1: float,
    b2: float,
    eps: float,
    weight_decay: float,
) -> None:
    """``ref.adamw_update`` on the card: every param (bf16 or float32) and
    its float32 moments updated in place from its gradient (the param's
    dtype), all contiguous, 16-byte aligned and on one card; ``scale``,
    ``bc1``, ``bc2`` and ``lr`` float32 one-element tensors there, read by
    the kernel. The Python floats enter as float32, as PyTorch takes them.
    One launch a pack; raises on anything the kernel does not take."""
    if not (len(params) == len(grads) == len(mus) == len(nus)) or not params:
        raise ValueError(f"adamw.update: {len(params)} params, {len(grads)} gradients, "
                         f"{len(mus)} and {len(nus)} moments")
    device = params[0].device
    _build.check_device(params[0])
    for i, (p, g, m, v) in enumerate(zip(params, grads, mus, nus)):
        n = p.numel()
        _check_leaf(p, f"adamw.update: param {i}", p.dtype, device, n)
        _check_leaf(g, f"adamw.update: gradient {i}", p.dtype, device, n)
        _check_leaf(m, f"adamw.update: first moment {i}", torch.float32, device, n)
        _check_leaf(v, f"adamw.update: second moment {i}", torch.float32, device, n)
    for t, what in ((scale, "scale"), (bc1, "bc1"), (bc2, "bc2"), (lr, "lr")):
        _check_scalar(t, what, device)
    numels = [p.numel() for p in params]
    p_ = plan(numels, [p.dtype for p in params])
    if not p_.packs:
        return
    ptrs = [(g.data_ptr(), p.data_ptr(), m.data_ptr(), v.data_ptr())
            for p, g, m, v in zip(params, grads, mus, nus)]
    consts = (b1, 1 - b1, b2, 1 - b2, eps, weight_decay)
    if not all(math.isfinite(c) for c in consts):
        raise ValueError(f"adamw.update: hyperparameters {consts}")
    _launch(1, p_, ptrs, numels, params[0],
            scalars=[t.data_ptr() for t in (scale, bc1, bc2, lr)], consts=consts)
