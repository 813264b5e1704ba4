"""Mamba2's SSD mixer as two kernels (CUDA): the chunked scan of a prefill
(SSD-scan) and the decode step's mixer (SSD-step).

Wrappers of ``csrc/ssd_scan.cu`` and ``csrc/ssd_step.cu``. They replace no
Pallas kernel: the JAX package's Mamba2 block is jnp, ``ssd_scan``
(``src/repro/models/ssm.py:93``) and ``mamba2_decode`` (``:257``), which XLA
fuses inside the jitted prefill and decode programs. Their plain versions
are ``ref.ssd_scan`` and ``ref.ssd_step``; ``ops.ssd_scan`` and
``ops.ssd_step`` pick between them and this module by the device of the
tensors.

- ``ssd_scan``: y and the final float32 state of the scan over S steps,
  from a given state or zero. The kernel takes its own chunk length
  (``CHUNK`` for every S, whatever the model's ``chunk_size``: the chunked
  form equals the recurrence up to rounding; the last chunk is masked past
  S, which is not padded in memory) and one block per (sequence, head, slice
  of ``P_SLICE`` channels) (``scan_grid``). Two kernels: ``mma``
  (``SCAN_VARIANT``, every call on the path), its chunk products on the
  tensor cores (the Gram of bf16 B and C in bf16, every product with a
  float32 operand 3xTF32, never single-pass TF32), four warps a strip of
  ``TILE`` rows each and four the state, the next chunk staged by
  cp.async; and ``cuda_core``, the first kernel (float32 FMAs), which only
  ``scan_prior`` launches (``chip_smoke.py``'s ``prior_ms``). There is no
  backward kernel:
  ``scan_route`` sends a CUDA call that needs a gradient nowhere (it
  raises), and the train block calls the plain version itself.
- ``ssd_step``: one token for R tenants x B slots from the projections'
  outputs to ``out_proj``'s input, the caches updated in place; one launch
  a layer, one block per (sequence, head) (``step_grid``), the state read
  first and in full 512-byte rows a warp (``STEP_VARIANT``). An integer
  arrival counter a sequence (``step_work_ints``) is kept with the state it
  guards (``step_arrivals``): made zeroed once, left at zero by every
  launch, so a launch allocates and zeroes nothing.

Shapes the kernels take (zamba2-7b's): P = 64 channels a head, state N = 64,
conv window W = 4 (``SUPPORTED``); float32 or bf16 model dtypes.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.multiprocessing.reductions import StorageWeakRef

from repro_torch.kernels import _build, ref

scan_counter = _build.OpCounter()
step_counter = _build.OpCounter()
SCAN_VARIANT = "mma"      # SSD-scan on the path: its chunk products on the tensor cores
STEP_VARIANT = "coalesced"  # SSD-step: a block a (sequence, head), the state read first, coalesced
# SSD-scan's kernels by C code: the first (float32 FMAs on CUDA cores, kept
# as the prior) and the tensor-core one
SCAN_VARIANT_CODES = {"cuda_core": 0, "mma": 1}
CHUNK = 64       # steps a chunk of the scan kernels (csrc/ssd_scan.cu's kL)
P_SLICE = 32     # channels of a head a scan block takes (kPS)
TILE = 16        # rows of a chunk one warp of the mma kernel takes (kTile): a piece's granularity
SUPPORTED = {"P": 64, "N": 64, "W": 4}
# the step's params and caches, in the order the launch takes their pointers
STEP_PARAMS = ("conv_x_w", "conv_x_b", "conv_B_w", "conv_B_b", "conv_C_w", "conv_C_b",
               "A_log", "D", "dt_bias", "norm")
STEP_CACHES = ("conv_x", "conv_B", "conv_C", "ssm")


def scan_grid(B: int, H: int, P: int) -> int:
    """Blocks of a scan launch: one per (sequence, head, ``P_SLICE``
    channels); zamba2's one-sequence prefill, 112 heads of 64, is 224."""
    return B * H * (P // P_SLICE)


def scan_smem_bytes(dtype: torch.dtype) -> int:
    """Dynamic shared memory of a block of the mma kernel: a two-chunk ring
    of the raw C and B (rows of N + 8 bf16 or N + 4 float32 elements), x
    (P_SLICE + 8 or + 4) and dt, the state slice (rows of N + 8 float32)
    twice, each strip's y_c (TILE rows x P_SLICE, float32) handed from a
    state warp to its y warp, and the prefix sums of A dt of two chunks."""
    N, L = SUPPORTED["N"], CHUNK
    e = 2 if dtype == torch.bfloat16 else 4
    pad = 8 if e == 2 else 4
    stage = 2 * L * (N + pad) * e + L * (P_SLICE + pad) * e + 4 * L
    return 2 * stage + 2 * P_SLICE * (N + 8) * 4 + L * P_SLICE * 4 + 2 * L * 4


def scan_tiles(S: int) -> Tuple[int, int]:
    """(chunks, strips of ``TILE`` rows in the last chunk) the mma kernel
    computes for S steps: a 1- to 16-token piece is one strip."""
    chunks = -(-S // CHUNK)
    return chunks, -(-(S - (chunks - 1) * CHUNK) // TILE)


def step_grid(R: int, B: int, H: int) -> int:
    """Blocks of a step launch: one per (sequence, head)."""
    return R * B * H


def step_work_ints(R: int, B: int) -> int:
    """The step's counters: one arrival counter (int32) a sequence, which
    each of its H blocks adds one to."""
    return R * B


# the step's arrival counters by (device, state address, sequences), each
# beside a weak reference to the storage of the state it guards
_ARRIVALS: Dict[Tuple[torch.device, int, int], Tuple[StorageWeakRef, torch.Tensor]] = {}


def step_arrivals(ssm: torch.Tensor, R: int, B: int) -> torch.Tensor:
    """The arrival counters of the steps on the state ``ssm`` (R x B
    sequences): ``step_work_ints(R, B)`` int32, zeroed when first asked
    for, then the same tensor for every launch on that state. The kernel's
    last block of a sequence resets its counter, so each launch leaves them
    at 0 for the next, eager or replayed in a CUDA graph (the step graphs
    are captured after an eager run on the same caches, so the counters
    already exist). Keyed by the state's address; two launches that share
    counters write one state, which no caller steps twice at once.

    A set lives as long as its state's storage: when a new set is made,
    those whose state was freed are dropped (a freed counter's memory goes
    back to its stream's pool, after any launch queued on it), so the
    registry holds the live states' sets and those freed since the last
    new one, however many states a server makes and frees. A state made at
    a freed one's address gets a new set at 0."""
    key = (ssm.device, ssm.data_ptr(), R * B)
    entry = _ARRIVALS.get(key)
    if entry is None or entry[0].expired():
        for k in [k for k, (state, _) in _ARRIVALS.items() if state.expired()]:
            del _ARRIVALS[k]
        entry = _ARRIVALS[key] = (
            StorageWeakRef(ssm.untyped_storage()),
            torch.zeros(step_work_ints(R, B), dtype=torch.int32, device=ssm.device))
    return entry[1]


def scan_route(is_cuda: bool, needs_grad: bool) -> str:
    """Where ``ops.ssd_scan`` sends a call, decided before any launch:
    "kernel" for CUDA tensors, "plain" for CPU and meta ones. There is no
    backward kernel, so a CUDA call that needs a gradient raises (the
    train block calls ``ops.ssd_scan_plain`` itself)."""
    if not is_cuda:
        return "plain"
    if needs_grad:
        raise NotImplementedError(
            "ssd_scan: no backward kernel; differentiate ops.ssd_scan_plain")
    return "kernel"


def _check_shapes(what: str, P: int, N: int, W: Optional[int] = None) -> None:
    got = {"P": P, "N": N} if W is None else {"P": P, "N": N, "W": W}
    want = {k: SUPPORTED[k] for k in got}
    if got != want:
        raise ValueError(f"{what}: the kernel takes {want}, got {got}")


def _contiguous(t: torch.Tensor, what: str, dtype: torch.dtype, shape: Tuple[int, ...],
                device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape) or not t.is_contiguous() or t.device != device:
        raise ValueError(f"{what}: expected a contiguous {tuple(shape)} tensor on {device}, got "
                         f"{tuple(t.shape)} (contiguous {t.is_contiguous()}) on {t.device}")


def ssd_scan(
    xh: torch.Tensor,
    dt: torch.Tensor,
    A: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    init_state: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ref.ssd_scan`` on the card: xh (B, S, H, P), Bm and Cm (B, S, N)
    of one dtype (float32 or bf16); dt (B, S, H) (post-softplus) and A (H,)
    float32; init_state (B, H, P, N) float32 or None (zero); all contiguous
    and 16-byte aligned on one card. Launches ``SCAN_VARIANT``'s kernel.
    Returns (y (B, S, H, P) in xh's dtype, the final state (B, H, P, N)
    float32). Raises on anything the kernel does not take."""
    return _scan(SCAN_VARIANT, xh, dt, A, Bm, Cm, init_state)


def scan_prior(xh, dt, A, Bm, Cm, init_state=None):
    """``ssd_scan`` by the first kernel, ``cuda_core``: how ``chip_smoke.py``
    checks and times it as ``prior_ms``. No path of the port calls it."""
    return _scan("cuda_core", xh, dt, A, Bm, Cm, init_state)


def _scan(kind, xh, dt, A, Bm, Cm, init_state):
    _build.check_device(xh)
    if xh.ndim != 4:
        raise ValueError(f"ssd_scan: xh must be (B, S, H, P), got {tuple(xh.shape)}")
    B, S, H, P = xh.shape
    N = Bm.shape[-1]
    _check_shapes("ssd_scan", P, N)
    if S == 0:
        raise ValueError("ssd_scan: empty sequence")
    if xh.dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ssd_scan: xh dtype {xh.dtype}")
    dev = xh.device
    _build.check_tensor(xh, "ssd_scan: xh", xh.dtype)
    for t, what, dtype, shape in ((dt, "dt", torch.float32, (B, S, H)),
                                  (A, "A", torch.float32, (H,)),
                                  (Bm, "Bm", xh.dtype, (B, S, N)),
                                  (Cm, "Cm", xh.dtype, (B, S, N))):
        _contiguous(t, f"ssd_scan: {what}", dtype, shape, dev)
        _build.check_tensor(t, f"ssd_scan: {what}")
    if init_state is not None:
        _contiguous(init_state, "ssd_scan: init_state", torch.float32, (B, H, P, N), dev)
        _build.check_tensor(init_state, "ssd_scan: init_state")
    y = torch.empty_like(xh)
    state = torch.empty((B, H, P, N), dtype=torch.float32, device=dev)
    lib = _build.load("ssd_scan")
    with torch.cuda.device(dev):
        status = lib.repro_ssd_scan(
            xh.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
            None if init_state is None else init_state.data_ptr(), y.data_ptr(),
            state.data_ptr(), B, S, H, P, N, CHUNK, _build.DTYPE_CODES[xh.dtype],
            SCAN_VARIANT_CODES[kind], _build.stream_of(xh))
    _build.check_status(lib, "ssd_scan", status)
    scan_counter.launched(kind)
    return y, state


def ssd_step(
    p: Dict[str, torch.Tensor],
    cache: Dict[str, torch.Tensor],
    z: torch.Tensor,
    xs: torch.Tensor,
    Bm: torch.Tensor,
    Cm: torch.Tensor,
    dt: torch.Tensor,
) -> torch.Tensor:
    """``ref.ssd_step`` on the card, in one launch: z, xs (R, B, d_inner),
    Bm, Cm (R, B, N) and dt (R, B, H) raw, in the model dtype (float32 or
    bf16); ``p``'s tenant-stacked ``STEP_PARAMS`` (A_log, D, dt_bias
    float32, the rest the model dtype); ``cache``'s conv windows (model
    dtype) and float32 ``ssm`` state, updated in place. All contiguous on
    one card. Returns y (R, B, d_inner) in the model dtype. Raises on
    anything the kernel does not take."""
    _build.check_device(z)
    if z.ndim != 3:
        raise ValueError(f"ssd_step: z must be (R, B, d_inner), got {tuple(z.shape)}")
    R, B, d_inner = z.shape
    H = p["A_log"].shape[-1]
    P, N = d_inner // H, Bm.shape[-1]
    W = p["conv_x_w"].shape[-2]
    _check_shapes("ssd_step", P, N, W)
    dtype, dev = z.dtype, z.device
    if dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ssd_step: model dtype {dtype}")
    f32 = torch.float32
    want = {
        "xs": (xs, dtype, (R, B, d_inner)), "Bm": (Bm, dtype, (R, B, N)),
        "Cm": (Cm, dtype, (R, B, N)), "dt": (dt, dtype, (R, B, H)), "z": (z, dtype, z.shape),
        "conv_x_w": (p["conv_x_w"], dtype, (R, W, d_inner)),
        "conv_x_b": (p["conv_x_b"], dtype, (R, d_inner)),
        "conv_B_w": (p["conv_B_w"], dtype, (R, W, N)), "conv_B_b": (p["conv_B_b"], dtype, (R, N)),
        "conv_C_w": (p["conv_C_w"], dtype, (R, W, N)), "conv_C_b": (p["conv_C_b"], dtype, (R, N)),
        "A_log": (p["A_log"], f32, (R, H)), "D": (p["D"], f32, (R, H)),
        "dt_bias": (p["dt_bias"], f32, (R, H)), "norm": (p["norm"], dtype, (R, d_inner)),
        "conv_x": (cache["conv_x"], dtype, (R, B, W - 1, d_inner)),
        "conv_B": (cache["conv_B"], dtype, (R, B, W - 1, N)),
        "conv_C": (cache["conv_C"], dtype, (R, B, W - 1, N)),
        "ssm": (cache["ssm"], f32, (R, B, H, P, N)),
    }
    for what, (t, dt_, shape) in want.items():
        _contiguous(t, f"ssd_step: {what}", dt_, shape, dev)
    if cache["ssm"].data_ptr() % 16:
        raise ValueError("ssd_step: the ssm state must be 16-byte aligned")
    y = torch.empty_like(xs)
    arrivals = step_arrivals(cache["ssm"], R, B)
    lib = _build.load("ssd_step")
    ptrs = [t.data_ptr() for t in (z, xs, Bm, Cm, dt)]
    ptrs += [p[k].data_ptr() for k in STEP_PARAMS]
    ptrs += [cache[k].data_ptr() for k in STEP_CACHES]
    with torch.cuda.device(dev):
        status = lib.repro_ssd_step(*ptrs, y.data_ptr(), arrivals.data_ptr(), R, B, H, P, N, W,
                                    _build.DTYPE_CODES[dtype], ref.SSD_NORM_EPS,
                                    _build.stream_of(z))
    _build.check_status(lib, "ssd_step", status)
    step_counter.launched(STEP_VARIANT)
    return y
