"""Causal / sliding-window GQA flash attention (K4, CUDA).

Wrapper of ``csrc/flash_attention.cu``, the port of the JAX package's
Pallas ``flash_attention``. Unlike the TPU kernel, ``q_offset`` (absolute
position of the first query) is a runtime argument, so chunked prefill
runs the kernel too: a host int, or a 0-dim int64 tensor on the card that
the kernel reads in place (a captured prefill program's ``start``, which
changes from replay to replay; the wrapper never reads its value). Its
plain PyTorch version is ``ref.attention``;
``ops.flash_attention`` picks between them by the device of the tensors.
On the card, ``variant`` picks one of the source's two kernels by dtype
and head dim before the launch: the bf16 tensor-core kernel (wgmma fed by
TMA; at D = 112 a row is laid out as two 128-byte boxes, 128 columns, whose
last 16 TMA fills with zeros) or the CUDA-core kernel (float32, and bf16
at D = 32).

``flash_attention_bwd`` wraps ``csrc/flash_attention_bwd.cu``: the
gradient of K4 for training (queries and keys both at positions 0..S-1),
which ``ops.flash_attention`` launches from the backward of its autograd
route. ``bwd_variant`` picks its kernel by a rule of its own: the bf16
tensor-core kernel at D = 64, 128 and 256, which reads each row's
log-sum-exp that the forward's wgmma kernel wrote into an ``lse`` buffer
(``ref.attention_lse`` is its plain version), or the CUDA-core kernel,
which recomputes it (float32, and bf16 at D = 32 and 112: the backward has
no padded layout). Its plain
version is ``ref.attention_bwd``; it counts its launches in
``bwd_counter`` by variant.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

from repro_torch.kernels import _build

counter = _build.OpCounter()
SUPPORTED_HEAD_DIMS = (32, 64, 112, 128, 256)
# the forward's wgmma head dims: rows of whole 64-column (128-byte) swizzle
# boxes, D = 112 laid out as 128 (its columns 112-127 the zeros TMA reads
# past the tensor)
WGMMA_HEAD_DIMS = (64, 112, 128, 256)
WGMMA_BWD_HEAD_DIMS = (64, 128, 256)  # the backward's: no padded layout


def variant(dtype: torch.dtype, D: int) -> str:
    """The kernel that computes attention of ``dtype`` at head dim ``D``:
    wgmma for bf16 at D = 64, 112, 128 and 256 (one to four 128-byte
    swizzle boxes a row, 112 padded to two), the CUDA-core kernel for
    float32 and for bf16 at D = 32 (a 64-byte row is half a box)."""
    if dtype == torch.bfloat16 and D in WGMMA_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    logit_softcap: float = 0.0,
    q_offset: Optional[Union[int, torch.Tensor]] = None,
    kernel: Optional[str] = None,
    lse: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """q (B,Hq,Sq,D), k/v (B,Hkv,Skv,D) -> (B,Hq,Sq,D).

    Launches a CUDA kernel on the tensors' card: ``variant(dtype, D)``'s,
    or ``kernel`` where given (how ``chip_smoke.py`` times the CUDA-core
    kernel on bf16); raises on anything the kernel does not take (device,
    dtype, layout, head dim, softcap). ``lse``, a contiguous float32
    (B,Hq,Sq) buffer, is filled with each row's log-sum-exp of its scaled
    visible scores (+inf where none is visible) as ``ref.attention_lse``
    gives it; only the wgmma kernel writes one (training's autograd route
    passes it, serving none). ``q_offset`` may be a 0-dim int64 tensor on
    q's card (``check_offset``): both kernels then read it on the device,
    and nothing here synchronises, so the launch can be captured.
    """
    _build.check_device(q)
    if logit_softcap != 0.0:
        raise NotImplementedError(
            "flash_attention: the CUDA kernel computes no logit_softcap, as the Pallas "
            "kernel computes none; ops.flash_attention sends it to the plain version")
    B, Hq, Sq, D = q.shape
    Bk, Hkv, Skv, Dk = k.shape
    if k.shape != v.shape or (Bk, Dk) != (B, D) or Hq % Hkv:
        raise ValueError(
            f"flash_attention: shapes q {tuple(q.shape)} k {tuple(k.shape)} v {tuple(v.shape)}")
    if D not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {D} not in {SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention: dtype {q.dtype} not supported")
    for t, what in ((q, "q"), (k, "k"), (v, "v")):
        _build.check_tensor(t, what, q.dtype)
        if t.device != q.device:
            raise ValueError("flash_attention: all tensors must be on one device")
    kind = kernel or variant(q.dtype, D)
    if kind not in _build.VARIANT_CODES or (kind == "wgmma" and variant(q.dtype, D) != "wgmma"):
        raise ValueError(f"flash_attention: variant {kind!r} does not take {q.dtype} D={D}")
    if lse is not None:
        if kind != "wgmma":
            raise ValueError(f"flash_attention: the {kind} kernel writes no lse")
        _stats(lse, (B, Hq, Sq), q.device, "lse")
    offset_dev = None
    if isinstance(q_offset, torch.Tensor):
        check_offset(q_offset, q.device)
        offset_dev, q_offset = q_offset.data_ptr(), 0
    else:
        q_offset = Skv - Sq if q_offset is None else int(q_offset)
    out = torch.empty_like(q)
    if Sq == 0 or Skv == 0:
        return out.zero_()
    scale = scale if scale is not None else D ** -0.5
    lib = _build.load("flash_attention")
    with torch.cuda.device(q.device):
        status = lib.repro_flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), offset_dev, B, Hq, Hkv, Sq, Skv, D,
            int(bool(causal)), int(window), q_offset, _build.DTYPE_CODES[q.dtype],
            _build.VARIANT_CODES[kind], float(scale), _build.stream_of(q))
    _build.check_status(lib, "flash_attention", status)
    counter.launched(kind)
    return out


def check_offset(q_offset: torch.Tensor, device: torch.device) -> None:
    """Raise unless a tensor ``q_offset`` is what the kernels read in place
    of a host int: one int64 on ``device``. Its value is not looked at."""
    if q_offset.dtype != torch.int64 or q_offset.numel() != 1 or q_offset.device != device:
        raise ValueError(f"flash_attention: a tensor q_offset must be one int64 on {device}, "
                         f"got {tuple(q_offset.shape)} {q_offset.dtype} on {q_offset.device}")


def _stats(t: torch.Tensor, shape, device, what: str) -> None:
    if t.dtype != torch.float32 or tuple(t.shape) != tuple(shape) or not t.is_contiguous() \
            or t.device != device:
        raise ValueError(f"flash_attention: {what} must be a contiguous float32 tensor of shape "
                         f"{tuple(shape)} on {device}, got {tuple(t.shape)} {t.dtype} {t.device}")


bwd_counter = _build.OpCounter()


def bwd_variant(dtype: torch.dtype, D: int) -> str:
    """The backward kernel for ``dtype`` at head dim ``D``: wgmma (bf16
    tensor cores, reading the forward's ``lse``) for bf16 at D = 64, 128
    and 256; the CUDA-core kernel (float32 arithmetic, its own row pass)
    for float32 and for bf16 at D = 32 and 112, where the forward runs
    wgmma but the backward has no padded layout (no path trains at 112)."""
    if dtype == torch.bfloat16 and D in WGMMA_BWD_HEAD_DIMS:
        return "wgmma"
    return "cuda_core"


def check_bwd(q: torch.Tensor, k: torch.Tensor, *, q_offset: Optional[int] = None) -> None:
    """Raise unless the backward kernel takes this call: Sq == Skv with the
    queries at positions 0..S-1 (what training passes), a head dim and dtype
    the forward takes (a softcap never gets here: ``ops.flash_attention``
    sends it to the plain version). ``ops.flash_attention`` asks before the
    forward launch, so a call the backward cannot take never starts."""
    Sq, Skv = q.shape[2], k.shape[2]
    if isinstance(q_offset, torch.Tensor):  # training passes none; its value would sync
        raise ValueError("flash_attention_bwd: takes a host q_offset (0), not a tensor")
    if Sq != Skv or (q_offset is not None and int(q_offset) != 0):
        raise ValueError(f"flash_attention_bwd: takes Sq == Skv with q_offset 0 (training), "
                         f"got Sq={Sq} Skv={Skv} q_offset={q_offset}")
    if q.shape[-1] not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head dim {q.shape[-1]} not in "
                         f"{SUPPORTED_HEAD_DIMS}")
    if q.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"flash_attention_bwd: dtype {q.dtype} not supported")


def flash_attention_bwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    do: torch.Tensor,
    *,
    lse: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: int = 0,
    scale: Optional[float] = None,
    kernel: Optional[str] = None,
):
    """(dq, dk, dv) of ``flash_attention(q, k, v)`` (Sq == Skv, q_offset 0)
    given its output ``o`` and the output's gradient ``do``, in the inputs'
    dtype. Launches ``csrc/flash_attention_bwd.cu`` on the tensors' card:
    ``bwd_variant``'s kernels, or ``kernel``'s where given (how
    ``chip_smoke.py`` times the CUDA-core kernel on bf16). The wgmma
    kernels read ``lse``, the forward's (B,Hq,S) float32 log-sum-exp of
    each row, and compute rowsum(dO o O), dK/dV and dQ; the CUDA-core
    kernels recompute the log-sum-exp in a row pass and take no ``lse``.
    Raises on anything the kernel does not take. ``do`` may be strided
    (autograd hands it over as the next op produced it): it is made
    contiguous here."""
    _build.check_device(q)
    check_bwd(q, k)
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    if k.shape != v.shape or k.shape != (B, Hkv, S, D) or Hq % Hkv or o.shape != q.shape \
            or do.shape != q.shape:
        raise ValueError(f"flash_attention_bwd: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} o {tuple(o.shape)} do {tuple(do.shape)}")
    do = do.to(q.dtype).contiguous()
    for t, what in ((q, "q"), (k, "k"), (v, "v"), (o, "o"), (do, "do")):
        _build.check_tensor(t, what, q.dtype)
        if t.device != q.device:
            raise ValueError("flash_attention_bwd: all tensors must be on one device")
    kind = kernel or bwd_variant(q.dtype, D)
    if kind not in _build.VARIANT_CODES or (kind == "wgmma" and bwd_variant(q.dtype, D) != kind):
        raise ValueError(f"flash_attention_bwd: variant {kind!r} does not take {q.dtype} D={D}")
    if kind == "wgmma":
        if lse is None:
            raise ValueError("flash_attention_bwd: the wgmma kernel needs the forward's lse")
        _stats(lse, (B, Hq, S), q.device, "lse")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if S == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((B, Hq, S), dtype=torch.float32, device=q.device)
    if kind == "cuda_core":  # scratch for its row pass
        lse = torch.empty_like(delta)
    scale = scale if scale is not None else D ** -0.5
    lib = _build.load("flash_attention_bwd")
    with torch.cuda.device(q.device):
        status = lib.repro_flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            B, Hq, Hkv, S, D, int(bool(causal)), int(window), _build.DTYPE_CODES[q.dtype],
            _build.VARIANT_CODES[kind], float(scale), _build.stream_of(q))
    _build.check_status(lib, "flash_attention_bwd", status)
    bwd_counter.launched(kind)
    return dq, dk, dv
