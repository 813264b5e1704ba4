"""Checkpoints of param/optimizer trees in the JAX package's file format.

The reference writes ``msgpack.packb({"step": step, "leaves": [{"dtype",
"shape", "data"}, ...]}, use_bin_type=True)``. The port imports only
torch, numpy and the standard library, so it writes and reads that file
itself: the few msgpack types the payload holds (map, str, int, array,
bin) in msgpack's smallest encodings, which is what ``packb`` emits, so the
bytes are the reference's. Leaves go in ``jax.tree.flatten``'s order:
dict keys sorted, lists and tuples (``AdamWState`` too) in order. bf16
leaves are widened to float32 for storage, as numpy has no bf16. Both
directions stream leaf by leaf, so a full-width tree never sits in host
memory twice; a leaf on the card passes through one pinned host buffer
(``_Staging``), which the copies to and from the card run at full speed
through.
"""

from __future__ import annotations

import os
import struct
from typing import Any, BinaryIO, Dict, Iterator, List, Optional

import numpy as np
import torch

Pytree = Any

# numpy's names, which the reference writes (``str(np.asarray(leaf).dtype)``)
_DTYPE_NAMES = {torch.float32: "float32", torch.bfloat16: "bfloat16", torch.float16: "float16",
                torch.float64: "float64", torch.int32: "int32", torch.int64: "int64",
                torch.int8: "int8", torch.uint8: "uint8", torch.bool: "bool"}


# ------------------------------------------------------------------ tree order
def flatten(tree: Pytree) -> List[Any]:
    """Leaves in ``jax.tree.flatten``'s order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flatten(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in flatten(v)]
    return [tree]


def unflatten(like: Pytree, leaves: Iterator[Any]) -> Pytree:
    """A tree of ``like``'s structure holding the next leaves of ``leaves``."""
    if isinstance(like, dict):
        built = {k: unflatten(like[k], leaves) for k in sorted(like)}
        return {k: built[k] for k in like}  # the caller's key order
    if isinstance(like, list):
        return [unflatten(v, leaves) for v in like]
    if isinstance(like, tuple):
        items = [unflatten(v, leaves) for v in like]
        return type(like)(*items) if hasattr(like, "_fields") else tuple(items)
    return next(leaves)


# ------------------------------------------------------------------ msgpack subset
def _str(s: str) -> bytes:
    b = s.encode("utf-8")
    n = len(b)
    if n < 32:
        return bytes([0xA0 | n]) + b
    for marker, bits in ((0xD9, 8), (0xDA, 16), (0xDB, 32)):
        if n < (1 << bits):
            return bytes([marker]) + n.to_bytes(bits // 8, "big") + b
    raise ValueError("msgpack: string too long")


def _int(v: int) -> bytes:
    if 0 <= v < 128:
        return bytes([v])
    if -32 <= v < 0:
        return struct.pack(">b", v)
    if v >= 0:
        for marker, fmt, top in ((0xCC, ">B", 0xFF), (0xCD, ">H", 0xFFFF),
                                 (0xCE, ">I", 0xFFFFFFFF), (0xCF, ">Q", (1 << 64) - 1)):
            if v <= top:
                return bytes([marker]) + struct.pack(fmt, v)
    else:
        for marker, fmt, low in ((0xD0, ">b", -0x80), (0xD1, ">h", -0x8000),
                                 (0xD2, ">i", -0x80000000), (0xD3, ">q", -(1 << 63))):
            if v >= low:
                return bytes([marker]) + struct.pack(fmt, v)
    raise ValueError(f"msgpack: integer {v} out of range")


def _container(n: int, fix: int, m16: int, m32: int) -> bytes:
    if n < 16:
        return bytes([fix | n])
    if n < (1 << 16):
        return bytes([m16]) + struct.pack(">H", n)
    return bytes([m32]) + struct.pack(">I", n)


def _map(n: int) -> bytes:
    return _container(n, 0x80, 0xDE, 0xDF)


def _array(n: int) -> bytes:
    return _container(n, 0x90, 0xDC, 0xDD)


def _bin_head(n: int) -> bytes:
    for marker, bits in ((0xC4, 8), (0xC5, 16), (0xC6, 32)):
        if n < (1 << bits):
            return bytes([marker]) + n.to_bytes(bits // 8, "big")
    raise ValueError("msgpack: bin too long")


class _Reader:
    """Reads the msgpack subset above from a binary file, one value at a time."""

    def __init__(self, f: BinaryIO):
        self.f = f

    def _take(self, n: int) -> bytes:
        b = self.f.read(n)
        if len(b) != n:
            raise ValueError("checkpoint: truncated file")
        return b

    def _uint(self, nbytes: int) -> int:
        return int.from_bytes(self._take(nbytes), "big")

    def value(self) -> Any:
        c = self._take(1)[0]
        if c < 0x80:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self._map_body(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return [self.value() for _ in range(c & 0x0F)]
        if 0xA0 <= c <= 0xBF:
            return self._take(c & 0x1F).decode("utf-8")
        if c in (0xC4, 0xC5, 0xC6):
            return self._take(self._uint({0xC4: 1, 0xC5: 2, 0xC6: 4}[c]))
        if c in (0xCC, 0xCD, 0xCE, 0xCF):
            return self._uint({0xCC: 1, 0xCD: 2, 0xCE: 4, 0xCF: 8}[c])
        if c in (0xD0, 0xD1, 0xD2, 0xD3):
            n = {0xD0: 1, 0xD1: 2, 0xD2: 4, 0xD3: 8}[c]
            return int.from_bytes(self._take(n), "big", signed=True)
        if c in (0xD9, 0xDA, 0xDB):
            return self._take(self._uint({0xD9: 1, 0xDA: 2, 0xDB: 4}[c])).decode("utf-8")
        if c in (0xDC, 0xDD):
            return [self.value() for _ in range(self._uint(2 if c == 0xDC else 4))]
        if c in (0xDE, 0xDF):
            return self._map_body(self._uint(2 if c == 0xDE else 4))
        raise ValueError(f"checkpoint: msgpack type 0x{c:02x} is not in the format")

    def _map_body(self, n: int) -> Dict[Any, Any]:
        out = {}
        for _ in range(n):
            key = self.value()
            out[key] = self.value()
        return out

    def bin_tensor(self, buffer: "_Staging", pinned: bool) -> torch.Tensor:
        """A bin value read straight into ``buffer``'s uint8 host memory."""
        c = self._take(1)[0]
        if c not in (0xC4, 0xC5, 0xC6):
            raise ValueError("checkpoint: expected msgpack bin data")
        n = self._uint({0xC4: 1, 0xC5: 2, 0xC6: 4}[c])
        buf = buffer.get(n, pinned)
        if n and self.f.readinto(memoryview(buf.numpy())) != n:
            raise ValueError("checkpoint: truncated file")
        return buf

    def leaf(self, buffer: "_Staging", pinned: bool) -> Dict[str, Any]:
        """One leaf record {"dtype", "shape", "data"}, its data as uint8 host bytes."""
        rec: Dict[str, Any] = {}
        for _ in range(self.header(0x80)):
            key = self.value()
            rec[key] = self.bin_tensor(buffer, pinned) if key == "data" else self.value()
        return rec

    def header(self, expect: int) -> int:
        """Length of a map (``expect`` 0x80) or an array (0x90) that must come next."""
        c = self._take(1)[0]
        if c & 0xF0 == expect:
            return c & 0x0F
        wide = {0x80: (0xDE, 0xDF), 0x90: (0xDC, 0xDD)}[expect]
        if c == wide[0]:
            return self._uint(2)
        if c == wide[1]:
            return self._uint(4)
        raise ValueError(f"checkpoint: expected a msgpack {'map' if expect == 0x80 else 'array'}")


# ------------------------------------------------------------------ save / restore
class _Staging:
    """Host memory a leaf's bytes pass through: one pinned buffer, grown to
    the largest leaf, for leaves on the card (a copy between the card and
    pageable memory runs at a fraction of the link's rate); a fresh buffer
    for leaves on the CPU. Every copy through it is synchronous, so it is
    free again when the next leaf comes."""

    def __init__(self):
        self.pinned: Optional[torch.Tensor] = None

    def get(self, nbytes: int, pinned: bool) -> torch.Tensor:
        if not pinned:
            return torch.empty(nbytes, dtype=torch.uint8)
        if self.pinned is None or self.pinned.numel() < nbytes:
            self.pinned = None
            self.pinned = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
        return self.pinned[:nbytes]


def _storage(leaf: torch.Tensor, buffer: _Staging) -> np.ndarray:
    """The leaf's bytes in its storage dtype (bf16 widened to float32, on
    the leaf's device), as a flat host uint8 array."""
    t = leaf.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    t = t.contiguous()
    host = buffer.get(t.numel() * t.element_size(), t.is_cuda)
    host.view(t.dtype).view(t.shape).copy_(t)
    return host.numpy()


def save_checkpoint(path: str, tree: Pytree, step: Optional[int] = None) -> None:
    leaves = flatten(tree)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    buffer = _Staging()
    with open(tmp, "wb") as f:
        f.write(_map(2) + _str("step") + _int(step if step is not None else -1))
        f.write(_str("leaves") + _array(len(leaves)))
        for leaf in leaves:
            leaf = torch.as_tensor(leaf)
            data = _storage(leaf, buffer)
            f.write(_map(3) + _str("dtype") + _str(_DTYPE_NAMES[leaf.dtype]))
            f.write(_str("shape") + _array(leaf.dim()) + b"".join(_int(int(s)) for s in leaf.shape))
            f.write(_str("data") + _bin_head(data.nbytes))
            f.write(data)
    os.replace(tmp, path)



def restore_checkpoint(path: str, like: Pytree) -> Dict[str, Any]:
    """Restore into the structure, dtypes and devices of ``like``.
    Returns {"tree": ..., "step": ...}; raises ValueError on a leaf count
    that differs from ``like``'s."""
    like_leaves = flatten(like)
    buffer = _Staging()
    with open(path, "rb") as f:
        rd = _Reader(f)
        out: Dict[str, Any] = {}
        leaves: List[torch.Tensor] = []
        for _ in range(rd.header(0x80)):
            key = rd.value()
            if key != "leaves":
                out[key] = rd.value()
                continue
            n = rd.header(0x90)
            if n != len(like_leaves):
                raise ValueError(f"checkpoint has {n} leaves, expected {len(like_leaves)}")
            for ref in like_leaves:
                ref = torch.as_tensor(ref)
                rec = rd.leaf(buffer, ref.is_cuda)
                stored = torch.float32 if ref.dtype == torch.bfloat16 else ref.dtype
                data = rec["data"].view(stored).reshape(rec["shape"])
                leaves.append(data.to(device=ref.device).to(ref.dtype))
    return {"tree": unflatten(like, iter(leaves)), "step": out["step"]}
