"""The RWKV-6 WKV recurrence over a whole sequence (K5, CUDA).

Wrapper of ``csrc/wkv6_scan.cu``, the port of the JAX package's Pallas
``wkv6_scan``. Unlike the TPU kernel it starts from a given state and
returns the state after the last step: a float32 prefill (fresh or a
chunked continuation) keeps that state; a bf16 prefill scans its outputs
with w rounded to bf16 and keeps instead the state of the state pass
(``wkv6_state``, float32 w), so this kernel's state goes to a scratch
buffer there. Its plain
PyTorch version is ``ref.wkv6_scan``; ``ops.wkv6_scan`` picks between them
by the device of the tensors. On the card every call takes the chunked
kernel: chunks of ``CHUNK`` steps, each from the state entering it through
running products of decays (``csrc/wkv6_scan.cu`` gives the formulas), 16
value columns a block.

The kernel's heads are N = V = 64 (rwkv6-1.6b's). Smaller heads, as the
smoke variants (N = V = 32) and the reference's kernel tests (8, 16, 32,
also N != V) have, run by a fixed rule of the wrapper, decided from the
shapes before the launch (``padded_dims``): N and V are each padded with
zeros to 64. Padded r and k are 0, padded w is 0 (a finite decay of
exp(-1)), padded u and initial-state rows and columns are 0, so padded
state rows and columns stay 0 and add nothing to the outputs; the outputs'
padded columns are dropped and the state is copied back into the caller's
``final_state`` (which may be ``init_state`` itself). At N = V = 32 the
kernel does four times the state work the head needs.

``wkv6_scan_bwd`` wraps ``csrc/wkv6_scan_bwd.cu``: the gradient of a scan
from a zero state with no final-state gradient (training), which
``ops.wkv6_scan`` launches from the backward of its autograd route. It
takes the same head sizes by the same padding rule (padded r, k, u and w
give padded rows that stay zero in the state and in its gradient, padded v
and do padded columns, so the live gradients are the unpadded problem's;
the padded entries are dropped). Its ``cluster`` kernel reads the state
entering each 16-step chunk, which the forward's chunked kernel writes
into a ``ckpt`` buffer when given one (``ref.wkv6_chunk_states`` is its
plain version; padded heads keep the padded layout); the ``chunked``
kernel, the first version, recomputes them. Its plain version is
``ref.wkv6_scan_bwd``; it counts its launches in ``bwd_counter`` by
variant.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
KERNEL_N = KERNEL_V = 64  # the kernel's head: key (state rows) and value (state columns) dims
SUPPORTED_HEAD_SIZES = (8, 16, 32, 64)  # N and V each; below 64 by ``padded_dims``
# C codes of the source's kernels; "sequential" is the first version of K5
# (one dependent step at a time), launched only when asked for
# (chip_smoke.py times it as ``prior_ms``).
VARIANT_CODES = {"sequential": 0, "chunked": 1}
CHUNK = 16  # timesteps per chunk of the chunked kernel; boundaries at multiples of it


def variant(dtype: torch.dtype, T: int) -> str:
    """The kernel that scans ``T`` steps of ``dtype``: chunked for every
    dtype and length the wrapper takes (a scan shorter than ``CHUNK`` is one
    masked chunk)."""
    del dtype, T
    return "chunked"


def chunk_states_shape(BH: int, T: int, N: int, V: int) -> Tuple[int, int, int, int]:
    """Shape of the ``ckpt`` buffer of a scan of ``BH`` heads, ``T`` steps,
    key dim ``N`` and value dim ``V``: the state entering each of the
    ceil(T / CHUNK) chunks, at the kernel's padded head (``padded_dims``)."""
    return (BH, -(-T // CHUNK)) + padded_dims(N, V)


def padded_dims(N: int, V: int) -> Tuple[int, int]:
    """(N, V) as the kernel runs a head of key dim ``N`` and value dim
    ``V``: each of 8, 16, 32 and 64 zero-padded to the kernel's 64. Raises
    on any other size."""
    if N not in SUPPORTED_HEAD_SIZES or V not in SUPPORTED_HEAD_SIZES:
        raise ValueError(f"wkv6_scan: N={N} V={V}; the wrapper takes N and V in "
                         f"{SUPPORTED_HEAD_SIZES}")
    return KERNEL_N, KERNEL_V


def _pad_last(t: torch.Tensor, width: int) -> torch.Tensor:
    out = t.new_zeros(t.shape[:-1] + (width,))
    out[..., :t.shape[-1]] = t
    return out


def _heads4(t: torch.Tensor) -> torch.Tensor:
    """(BH, T, X) -> (BH, 1, T, X); (B, H, T, X) as it is."""
    return t.unsqueeze(1) if t.ndim == 3 else t


def _state(t: torch.Tensor, BH: int, N: int, V: int, what: str) -> None:
    if t.dtype != torch.float32 or not t.is_contiguous() or t.numel() != BH * N * V:
        raise ValueError(f"wkv6_scan: {what} must be a contiguous float32 tensor of "
                         f"{BH}x{N}x{V} elements, got {tuple(t.shape)} {t.dtype}")


def wkv6_scan(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
    final_state: Optional[torch.Tensor] = None,
    *,
    kernel: Optional[str] = None,
    ckpt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, w (BH, T, N) or (B, H, T, N); v (..., T, V); u (H, N) or (BH, N)
    float32; init_state (BH, N, V) float32 or None (zero).

    Returns (out (..., T, V) in r's dtype, laid out as v is; the state after
    step T, written into ``final_state`` (a float32 buffer of BH*N*V
    elements, which may be ``init_state`` itself) or a new (BH, N, V)
    tensor). The inputs may be strided views with a contiguous last dim.
    Launches a CUDA kernel on the tensors' card: ``variant``'s, or
    ``kernel`` where given (how ``chip_smoke.py`` times the sequential
    kernel), on heads zero-padded to ``padded_dims(N, V)`` where those
    differ from (N, V); raises on anything the kernel does not take
    (device, dtype, N or V outside ``SUPPORTED_HEAD_SIZES``, alignment).
    ``ckpt``, a contiguous float32 buffer of ``chunk_states_shape``, is
    filled with the state entering each chunk (only the chunked kernel
    writes one; training's autograd route passes it, serving none).
    """
    _build.check_device(r)
    if r.ndim not in (3, 4) or k.shape != r.shape or w.shape != r.shape \
            or v.ndim != r.ndim or v.shape[:-1] != r.shape[:-1]:
        raise ValueError(f"wkv6_scan: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} w {tuple(w.shape)}")
    T, N = r.shape[-2:]
    V = v.shape[-1]
    kernel_dims = padded_dims(N, V)
    if T == 0:
        raise ValueError("wkv6_scan: empty sequence")
    if r.dtype not in _build.DTYPE_CODES or k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6_scan: r/k/v dtypes {r.dtype} {k.dtype} {v.dtype}")
    if w.dtype not in (r.dtype, torch.float32):
        raise TypeError(f"wkv6_scan: w must be {r.dtype} or float32, got {w.dtype}")
    kind = kernel or variant(r.dtype, T)
    if kind not in VARIANT_CODES:
        raise ValueError(f"wkv6_scan: no kernel {kind!r}")
    r4, k4, v4, w4 = (_heads4(t) for t in (r, k, v, w))
    B, H = r4.shape[:2]
    BH = B * H
    if u.dtype != torch.float32 or not u.is_contiguous() or u.ndim != 2 \
            or u.shape[1] != N or BH % u.shape[0]:
        raise ValueError(f"wkv6_scan: u must be contiguous float32 (H, {N}) or (BH, {N}), "
                         f"got {tuple(u.shape)} {u.dtype}")
    if init_state is not None:
        _state(init_state, BH, N, V, "init_state")
    if final_state is None:
        final_state = torch.empty((BH, N, V), dtype=torch.float32, device=r.device)
    _state(final_state, BH, N, V, "final_state")
    for t in (k, v, w, u, final_state) + ((init_state,) if init_state is not None else ()):
        if t.device != r.device:
            raise ValueError("wkv6_scan: all tensors must be on one device")
    if ckpt is not None:
        if kind != "chunked":
            raise ValueError(f"wkv6_scan: the {kind} kernel writes no ckpt")
        _ckpt(ckpt, chunk_states_shape(BH, T, N, V), r.device)
    if kernel_dims != (N, V):
        return _scan_padded(r4, k4, v4, w4, u, init_state, final_state, v, kind, kernel_dims, ckpt)
    out = torch.empty_like(v, dtype=r.dtype)  # v's layout (strides preserved)
    out4 = _heads4(out)
    strides = []
    for t, what in ((r4, "r"), (k4, "k"), (v4, "v"), (w4, "w"), (out4, "out")):
        sb, sh, st, sx = t.stride()
        if sx != 1:
            raise ValueError(f"wkv6_scan: {what} must have a contiguous last dim")
        if what != "out":
            vec = 16 // t.element_size()
            if t.data_ptr() % 16 or sb % vec or sh % vec or st % vec:
                raise ValueError(f"wkv6_scan: {what} must be 16-byte aligned with strides "
                                 f"of whole 16-byte vectors, got strides {t.stride()}")
        strides += [sb, sh, st]
    packed = (ctypes.c_longlong * 15)(*strides)
    lib = _build.load("wkv6_scan")
    with torch.cuda.device(r.device):
        status = lib.repro_wkv6_scan(
            r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
            None if init_state is None else init_state.data_ptr(), final_state.data_ptr(),
            None if ckpt is None else ckpt.data_ptr(), out.data_ptr(), B, H, T, N, V,
            u.shape[0], ctypes.addressof(packed), _build.DTYPE_CODES[r.dtype],
            int(w.dtype == torch.float32), VARIANT_CODES[kind], _build.stream_of(r))
    _build.check_status(lib, "wkv6_scan", status)
    counter.launched(kind, size=T)
    return out, final_state


def _ckpt(t: torch.Tensor, shape, device) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or t.device != device:
        raise ValueError(f"wkv6_scan: ckpt must be a float32 tensor of shape {tuple(shape)} on "
                         f"{device}, got {tuple(t.shape)} {t.dtype} {t.device}")
    _build.check_tensor(t, "wkv6_scan: ckpt")  # contiguous, 16-byte aligned (float4 reads)


def _scan_padded(r4, k4, v4, w4, u, init_state, final_state, v, kind, dims, ckpt):
    """The scan of checked (B, H, T, N) and (B, H, T, V) inputs on heads
    zero-padded to ``dims`` (``padded_dims``): one launch on padded copies
    (``ckpt`` filled in the padded layout), then the outputs' and the
    state's live part copied out."""
    (N, V), (NP, VP) = (r4.shape[-1], v4.shape[-1]), dims
    BH = r4.shape[0] * r4.shape[1]
    state = torch.zeros((BH, NP, VP), dtype=torch.float32, device=r4.device)
    if init_state is not None:
        state[:, :N, :V] = init_state.view(BH, N, V)
    out_p, _ = wkv6_scan(*(_pad_last(t, NP) for t in (r4, k4)), _pad_last(v4, VP),
                         _pad_last(w4, NP), _pad_last(u, NP), state, state, kernel=kind, ckpt=ckpt)
    final_state.view(BH, N, V).copy_(state[:, :N, :V])
    out = torch.empty_like(v, dtype=r4.dtype)
    _heads4(out).copy_(out_p[..., :V])
    return out, final_state


bwd_counter = _build.OpCounter()
BWD_SLICES = KERNEL_V // 16  # value-column slices, one block each, of the backward kernels
# C codes of the backward's kernels; "chunked" is the first version (its own
# forward re-run for the chunk states), launched only when asked for
# (chip_smoke.py times it as ``prior_ms``).
BWD_VARIANT_CODES = {"chunked": 0, "cluster": 1}


def bwd_variant(dtype: torch.dtype, T: int) -> str:
    """The backward kernel for ``T`` steps of ``dtype``: ``cluster`` (a
    head's four value slices in one thread-block cluster, from the chunk
    states the forward saved) for every dtype and length it takes."""
    del dtype, T
    return "cluster"


def check_bwd(r: torch.Tensor, v: torch.Tensor, init_state, final_state) -> None:
    """Raise unless the backward kernel takes this scan: from a zero state
    with no state kept (training), N and V as ``padded_dims`` takes them.
    ``ops.wkv6_scan`` asks before the forward launch."""
    if init_state is not None or final_state is not None:
        raise ValueError("wkv6_scan_bwd: the gradient is taken from a zero initial state "
                         "with no final state kept (training); got a state")
    padded_dims(r.shape[-1], v.shape[-1])
    if r.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"wkv6_scan_bwd: dtype {r.dtype} not supported")


def wkv6_scan_bwd(
    r: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    w: torch.Tensor,
    u: torch.Tensor,
    do: torch.Tensor,
    *,
    ckpt: Optional[torch.Tensor] = None,
    kernel: Optional[str] = None,
):
    """(dr, dk, dv, dw, du) of ``wkv6_scan(r, k, v, w, u)`` from a zero
    state, given the outputs' gradient ``do``; each in its input's dtype and
    shape (du (H, N) summed over the batch for u (H, N)). Shapes as
    ``wkv6_scan`` takes them; strided inputs are copied contiguous (BH, T,
    X) and heads zero-padded to ``padded_dims``. Launches
    ``csrc/wkv6_scan_bwd.cu`` on the tensors' card: ``bwd_variant``'s kernel,
    or ``kernel``'s where given (how ``chip_smoke.py`` times the chunked
    kernel), then a kernel that sums du over the heads sharing u's row (and,
    for the chunked kernel, dr, dk, dw over its per-slice partials). The
    cluster kernel reads ``ckpt``, the forward's chunk-entry states
    (``chunk_states_shape``); the chunked kernel takes none. Raises on
    anything the kernel does not take."""
    _build.check_device(r)
    if r.ndim not in (3, 4) or k.shape != r.shape or w.shape != r.shape \
            or v.ndim != r.ndim or v.shape[:-1] != r.shape[:-1] or do.shape != v.shape:
        raise ValueError(f"wkv6_scan_bwd: shapes r {tuple(r.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} w {tuple(w.shape)} do {tuple(do.shape)}")
    check_bwd(r, v, None, None)
    T, N = r.shape[-2:]
    V = v.shape[-1]
    NP, VP = padded_dims(N, V)
    if T == 0:
        raise ValueError("wkv6_scan_bwd: empty sequence")
    if k.dtype != r.dtype or v.dtype != r.dtype:
        raise TypeError(f"wkv6_scan_bwd: r/k/v dtypes {r.dtype} {k.dtype} {v.dtype}")
    if w.dtype not in (r.dtype, torch.float32):
        raise TypeError(f"wkv6_scan_bwd: w must be {r.dtype} or float32, got {w.dtype}")
    BH = r.numel() // (T * N)
    if u.dtype != torch.float32 or u.ndim != 2 or u.shape[1] != N or BH % u.shape[0]:
        raise ValueError(f"wkv6_scan_bwd: u must be float32 (H, {N}) or (BH, {N}), "
                         f"got {tuple(u.shape)} {u.dtype}")
    for t in (k, v, w, u, do):
        if t.device != r.device:
            raise ValueError("wkv6_scan_bwd: all tensors must be on one device")

    def flat(t, width, dtype=None):
        t = t.reshape(BH, T, t.shape[-1]).to(dtype or t.dtype)
        return (_pad_last(t, width) if t.shape[-1] != width else t).contiguous()

    kind = kernel or bwd_variant(r.dtype, T)
    if kind not in BWD_VARIANT_CODES:
        raise ValueError(f"wkv6_scan_bwd: no kernel {kind!r}")
    if kind == "cluster":
        if ckpt is None:
            raise ValueError("wkv6_scan_bwd: the cluster kernel needs the forward's ckpt")
        _ckpt(ckpt, chunk_states_shape(BH, T, N, V), r.device)
    r3, k3, w3 = flat(r, NP), flat(k, NP), flat(w, NP)
    v3, do3 = flat(v, VP), flat(do, VP, r.dtype)
    u2 = (_pad_last(u, NP) if N != NP else u).contiguous()
    dr3, dk3, dw3 = torch.empty_like(r3), torch.empty_like(k3), torch.empty_like(w3)
    dv3 = torch.empty_like(v3)
    du2 = torch.empty_like(u2)
    part = None
    if kind == "cluster":
        du_part = torch.empty((BH, NP), dtype=torch.float32, device=r.device)
    else:  # scratch for the first kernel's forward re-run and its slice partials
        ckpt = torch.empty(chunk_states_shape(BH, T, N, V), dtype=torch.float32, device=r.device)
        part = torch.empty((3, BWD_SLICES, BH, T, NP), dtype=torch.float32, device=r.device)
        du_part = torch.empty((BH, BWD_SLICES, NP), dtype=torch.float32, device=r.device)
    lib = _build.load("wkv6_scan_bwd")
    with torch.cuda.device(r.device):
        status = lib.repro_wkv6_scan_bwd(
            r3.data_ptr(), k3.data_ptr(), v3.data_ptr(), w3.data_ptr(), u2.data_ptr(),
            do3.data_ptr(), dr3.data_ptr(), dk3.data_ptr(), dv3.data_ptr(), dw3.data_ptr(),
            du2.data_ptr(), ckpt.data_ptr(), None if part is None else part.data_ptr(),
            du_part.data_ptr(), BH, T, u2.shape[0], _build.DTYPE_CODES[r.dtype],
            int(w.dtype == torch.float32), BWD_VARIANT_CODES[kind], _build.stream_of(r))
    _build.check_status(lib, "wkv6_scan_bwd", status)
    bwd_counter.launched(kind)

    def back(t, like, width):
        t = t[..., :width] if t.shape[-1] != width else t
        return t.reshape(like.shape)

    return (back(dr3, r, N), back(dk3, k, N), back(dv3, v, V), back(dw3, w, N),
            du2[:, :N].contiguous() if N != NP else du2)
