#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py                 # every phase, as a check run does
    python3 chip_smoke.py --phases 1      # kernels against plain versions only
    python3 chip_smoke.py --phases 3 --profile   # + where a decode step's time goes
    python3 chip_smoke.py --phases 4      # the GEMM super-kernel path only
    python3 chip_smoke.py --phases 4 --profile   # + where a GEMM dispatch's time goes (K1, K2)
    python3 chip_smoke.py --phases 5      # the RWKV-6 serving path only
    python3 chip_smoke.py --phases 5 --profile   # + where an RWKV decode step's time goes
    python3 chip_smoke.py --phases 6      # paligemma-3b, then musicgen, qwen2, granite, gemma3
    python3 chip_smoke.py --phases 6 --profile   # + where a paligemma decode step's time goes
    python3 chip_smoke.py --phases 7      # granite-moe, zamba2 and llama4-maverick
    python3 chip_smoke.py --phases 7 --profile   # + where their merged decode steps' time goes

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/repro_torch/``), then:

  1. holds every kernel against its plain PyTorch version on the card, in
     float32 and bfloat16, at the shapes of the serving path and at the
     edges of K4's tiles, and times the kernel, the plain version and
     ``scaled_dot_product_attention`` (the library yardstick, which the
     port never calls); an attention softcap must give the plain version's
     output with no kernel launch (the op's rule, as the reference's);
  2. builds stablelm-1.6b at full width (bf16, seeded random weights) and
     compares the kernel path's logits with the plain path's over a
     777-token prefill and 8 decode steps;
  3. serves 16 requests for four full-width stablelm-1.6b tenants through
     ``MultiTenantEngine`` in ``space_time`` and ``time_only`` mode, with
     every kernel's launch counter read around the run;
  4. drives the paper's GEMM super-kernel path: (a) holds K1
     ``batched_gemm`` and K2 ``grouped_gemm`` against their plain versions
     in float32 and bfloat16 and times them beside ``torch.bmm`` and the
     previous kernel; (b) runs
     Table 1, the four strategies over the paper's SGEMM shapes and R
     sweep; (c) drives ``DynamicSpaceTimeScheduler`` with bare
     ``GemmProblem``s on two stochastic streams (the ablation trace, and a
     ragged merge at stablelm-1.6b's MLP width), checks every result, and
     reads the launch counters around each run. Phase 4 runs with
     ``CUDA_DEVICE_MAX_CONNECTIONS=32``, so that space_only's 32 streams
     get 32 hardware queues; after other phases, which keep CUDA's
     default, it runs in a child process of its own;
  5. drives the RWKV-6 serving path: (a) holds K5 ``wkv6_scan`` (its
     chunked kernel) against its plain version in float32 and bfloat16,
     from a zero and a random state, whole and split in two, under strong
     and weak decay, and times it at a median prompt beside its first,
     sequential kernel (checked, then timed as ``prior_ms``); (b)
     builds rwkv6-1.6b at full width (seeded random weights, decay made
     data-dependent) and compares the kernel path's logits with the plain
     path's over a 777-token prefill, whole and chunked (512 + 265), and
     8 decode steps: in float32 directly, in bf16 each against the float32
     plain path; (c) serves 16 requests for four rwkv6-1.6b tenants (bf16)
     in ``space_time`` and ``time_only`` mode, with K5's launch counter
     read around the run and required at 24 per prefill, every launch
     chunked; with ``--profile``, K5's share of a prefill;
  6. drives paligemma-3b (head dim 256, 8 query heads on one kv head, a
     stub SigLIP frontend): (a) at full width (bf16, seeded random weights,
     18 layers), the kernel path's logits against the plain path's over a
     prefill of 256 seeded patch embeddings (1152 wide) and 521 tokens,
     then 8 decode steps; (b) serves the 16 requests of phase 3 for four
     paligemma-3b tenants in both modes (text only, as the reference's
     engine), every K4 launch wgmma, 18 per prefill, every K3 launch
     split_kv; (c) holds musicgen-large (a 64-frame prefix), qwen2-7b and
     granite-3-8b at full width and 2 layers, and gemma3-27b at full width
     and 6 layers (one global), kernel path against plain path over a
     prefill and 4 decode steps;
  7. drives the last three architectures: (a) granite-moe-1b-a400m (24
     layers of attention + MoE, top-8 of 32 experts with per-sequence
     capacity) and zamba2-7b (all 81 layers: 68 Mamba2 layers and one
     shared attention block of head dim 112 applied at 13 positions) at
     full width, kernel path against plain path over a whole prefill, a
     chunked one (512 + 265) and 8 decode steps, in float32 (within
     MODEL_RTOL) and in bf16 (phase 5b's scheme: each held against the
     float32 plain path), zamba2's chunked prefill also against its whole
     one; then llama4-maverick at full width and 2 of 48 layers (a dense
     layer and an MoE layer of all 128 experts and the shared expert, 37.1
     GB in bf16), kernel path against plain path; (b) serves the 16
     requests of phase 3 for four granite-moe tenants (10.7 GB) and four
     zamba2 tenants (45.9 GB, 8.2 GB of caches) in both modes, with their
     kernels rows.

K5 takes its chunked kernel for every shape (``wkv6_scan.variant``). K1, K2
and K4 each have a kernel for the tensor cores, picked by dtype and shape
before the launch (``batched_gemm.variant``, ``grouped_gemm.variant``,
``flash_attention.variant``): wgmma with TMA for bf16; otherwise K1's
register-tiled ``simt`` kernel (K split across a cluster) and K2's and K4's
CUDA-core kernels. K3 takes its ``split_kv`` kernel for every shape: the live
prefix of each (sequence, kv head) split across a thread-block cluster and
combined on chip; one launch takes up to 8 query heads per kv head, and a
larger ratio runs as one launch per head group of 8. K3 and K4 take head
dims 64, 112, 128 and 256; bf16 at head dim 112 takes K4's CUDA-core kernel.
Phase 1 checks K3 at its tile and split edges, at q_per_kv 1 to 8 and at 12
and 16 (two launches a call), at every head dim, and that two launches give
the same bits; phase 4a checks K1 at its row-tile, K and N edges and that a
problem's output is bit-identical whatever the others hold, on both of its
kernels. Launch checks count attention layers, not layers (zamba2: 13 of
81; its Mamba2 layers launch no kernel). Phases 3, 6b and 7b fail unless
every K4 launch on the serving path took the variant the wrapper's rule
gives (wgmma for stablelm, paligemma and granite-moe; cuda_core for
zamba2's bf16 D = 112), once per attention layer per prefill, and every K3
launch split_kv, once per attention layer per decode pass of the model;
phases 2, 6a, 6c and 7a unless K4 and K3 launched once per attention layer
per prefill (or chunk) and decode step, by the wrapper's rule; phase 4c
unless every K1 launch of scheduler run 1 took simt and every K1 and K2
launch of run 2 wgmma; phase 5c unless every K5 launch took chunked. Every
row of the ``kernels`` line carries the ``variant``, the ``shape`` it was
timed at, its launches by variant, and ``prior_ms``: the previous kernel's
time at the same inputs (K1: its first, CUDA-core kernel; K2, K4: the
CUDA-core variant; K3: its first, single-pass kernel, null at D = 112 and
256, where it has no instance; K5: its first, sequential
kernel), launched explicitly. Kernel times are device times of back-to-back
launches queued behind a sleep kernel, so the host's launch cost does not pace
them. The build prints ptxas's report for every kernel, the dynamic shared
memory of the wgmma kernels, K3's ring and K5's chunked kernel, and how many
of K3's clusters fit on the card at once. Each phase prints its wall time.

Prints a ``kernels`` JSON line, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, if
there is no CUDA card, if the port cannot be imported, or if any phase fails.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
PEAK_BYTES_PER_S = 3.35e12                 # H100 SXM HBM3 (data sheet)
PEAK_FLOPS = {"torch.bfloat16": 989e12,    # dense bf16 tensor cores
              "torch.float32": 67e12}      # float32 outside the tensor cores
# f32: the JAX kernel tests' own tolerance; only the order of float32 sums
# differs between kernel and plain version.
# bf16: both compute in float32 from the same bf16 inputs, then round the
# output to bf16 (8 mantissa bits, relative step 2^-8 = 3.9e-3); a sum-order
# difference can flip that rounding, so allow a few steps.
TOL = {"torch.float32": (2e-5, 2e-4), "torch.bfloat16": (2e-2, 2e-2)}
REPLACES = {
    "decode_attention": "src/repro/kernels/decode_attention.py:113",
    "flash_attention": "src/repro/kernels/flash_attention.py:150",
    "wkv6_scan": "src/repro/kernels/wkv6_scan.py:84",
}
ATTENTION_KERNELS = ("decode_attention", "flash_attention")  # phases 3 and 6's path
EXTRA_HEAD_DIMS = (112, 256)  # zamba2-7b's and paligemma-3b's head dims


SLEEP_CYCLES_PER_CALL = 400_000  # ~0.2 ms at the H100's ~2 GHz


class PhaseFailed(Exception):
    pass


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` back-to-back calls, by
    CUDA events. The calls are queued behind a sleep kernel long enough for
    the host to enqueue them all (~0.2 ms of sleep per call), so the events
    time the card's work and not the host's launch cost, which paces a
    kernel of a few tens of microseconds otherwise."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES_PER_CALL * iters)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got, want, dtype_key: str, tol=None) -> float:
    """Max |got - want|; raises PhaseFailed outside (rtol, atol), which
    default to TOL[dtype_key]."""
    import torch

    rtol, atol = tol or TOL[dtype_key]
    got32, want32 = got.float(), want.float()
    if not torch.isfinite(got32).all():
        raise PhaseFailed(f"{name}: kernel output has non-finite values")
    err = (got32 - want32).abs()
    max_err = float(err.max())
    bad = int((err > atol + rtol * want32.abs()).sum())
    verdict = "ok" if bad == 0 else f"FAIL ({bad} elements out of tolerance)"
    log(f"  {name}: max_abs_err={max_err:.3e} (rtol={rtol}, atol={atol}) {verdict}")
    if bad:
        raise PhaseFailed(f"{name}: {bad} elements out of tolerance")
    return max_err


# ----------------------------------------------------------------- bounds
def flash_work(B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, dtype):
    """(bytes, flops) the attention function needs for these inputs."""
    q_pos = np.arange(Sq)[:, None] + q_offset
    kv_pos = np.arange(Skv)[None, :]
    vis = np.ones((Sq, Skv), bool)
    if causal:
        vis &= q_pos >= kv_pos
    if window > 0:
        vis &= (q_pos - kv_pos) < window
    pairs = int(vis.sum())
    esize = 2 if "bfloat16" in dtype else 4
    nbytes = esize * (2 * B * Hq * Sq * D + 2 * B * Hkv * Skv * D)
    return nbytes, 4 * B * Hq * D * pairs


def decode_work(B, Hq, Hkv, S, D, lengths, dtype):
    esize = 2 if "bfloat16" in dtype else 4
    total = int(np.minimum(np.asarray(lengths), S).sum())
    nbytes = esize * (2 * B * Hq * D + 2 * total * Hkv * D) + 4 * B
    return nbytes, 4 * total * Hq * D


def bound(nbytes: float, flops: float, dtype: str):
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


# ----------------------------------------------------------------- library yardsticks
def sdpa_flash(q, k, v, causal, window, q_offset):
    import torch
    import torch.nn.functional as F

    Sq, Skv = q.shape[2], k.shape[2]
    q_pos = torch.arange(Sq, device=q.device)[:, None] + q_offset
    kv_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= q_pos >= kv_pos
    if window > 0:
        mask &= (q_pos - kv_pos) < window
    plain_causal = causal and window == 0 and q_offset == 0 and Sq == Skv
    g = q.shape[1] // k.shape[1]
    if g > 1:  # one call per function: GQA expanded once, outside the timing
        k, v = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1)
    if plain_causal:
        return lambda: F.scaled_dot_product_attention(q, k, v, is_causal=True)
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask)


def sdpa_decode(q, kc, vc, lengths):
    import torch
    import torch.nn.functional as F

    S = kc.shape[2]
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None])[:, None, None, :]
    g = q.shape[1] // kc.shape[1]
    if g > 1:
        kc, vc = kc.repeat_interleave(g, dim=1), vc.repeat_interleave(g, dim=1)
    q4 = q[:, :, None, :]
    return lambda: F.scaled_dot_product_attention(q4, kc, vc, attn_mask=mask)


# ----------------------------------------------------------------- phase 1
def check_flash(ops, dev, gen, dtype, B, Hq, Hkv, Sq, Skv, D, window, q_offset=None,
                causal=True):
    """K4 against its plain version on one case; returns (inputs, keywords,
    max error)."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    qo = Skv - Sq if q_offset is None else q_offset
    kw = dict(causal=causal, window=window, q_offset=qo)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    name = (f"flash_attention {str(dtype)[6:]} {(B, Hq, Hkv, Sq, Skv, D)} window={window} "
            f"q_offset={qo}{'' if causal else ' non-causal'} [{fa.variant(dtype, D)}]")
    return (q, k, v), kw, check_close(name, got, want, str(dtype))


def measure_flash(ops, dev, gen, dtype, B, Hq, Hkv, Sq, Skv, D, window, q_offset=None,
                  iters=20, prior=False):
    """K4 checked and timed beside its plain version and SDPA; with
    ``prior``, the CUDA-core variant too (checked, then timed as
    ``prior_ms``), launched explicitly on the same inputs."""
    import torch

    from repro_torch.kernels import flash_attention as fa

    (q, k, v), kw, err = check_flash(ops, dev, gen, dtype, B, Hq, Hkv, Sq, Skv, D, window,
                                     q_offset)
    nbytes, flops = flash_work(B, Hq, Hkv, Sq, Skv, D, True, window, kw["q_offset"], str(dtype))
    bound_ms, bound_by = bound(nbytes, flops, str(dtype))
    row = {
        "variant": fa.variant(dtype, D),
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw), iters),
        "plain_ms": time_ms(lambda: ops.flash_attention_plain(q, k, v, **kw), 3, 1),
        "library_ms": time_ms(sdpa_flash(q, k, v, True, window, kw["q_offset"]), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if prior:
        check_close("  its CUDA-core variant", fa.flash_attention(q, k, v, kernel="cuda_core", **kw),
                    ops.flash_attention_plain(q, k, v, **kw), str(dtype))
        row["prior_ms"] = time_ms(lambda: fa.flash_attention(q, k, v, kernel="cuda_core", **kw),
                                  iters)
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} sdpa_ms={row['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})"
        + (f" prior_ms={row['prior_ms']:.4f} (CUDA cores)" if prior else ""))
    return row


def decode_inputs(gen, dev, dtype, B, Hq, Hkv, S, D, lengths):
    import torch

    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    kc = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    vc = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    return q, kc, vc, torch.as_tensor(np.asarray(lengths, np.int32), device=dev)


def check_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths):
    """K3 against its plain version on one case, and against itself: a
    second launch on the same inputs must give the same bits. Returns
    (inputs, max error)."""
    import torch

    from repro_torch.kernels import decode_attention as da

    q, kc, vc, lens = decode_inputs(gen, dev, dtype, B, Hq, Hkv, S, D, lengths)
    got = ops.decode_attention(q, kc, vc, lens)
    again = ops.decode_attention(q, kc, vc, lens)
    want = ops.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    shown = lengths if len(lengths) <= 8 else f"min={min(lengths)} max={max(lengths)}"
    name = (f"decode_attention {str(dtype)[6:]} {(B, Hq, Hkv, S, D)} lengths {shown} "
            f"[{da.variant(dtype, D)}, {da.splits(S)} splits]")
    err = check_close(name, got, want, str(dtype))
    if not torch.equal(got, again):
        raise PhaseFailed(f"{name}: two launches on the same inputs differ")
    return (q, kc, vc, lens), err


def check_decode_groups(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths):
    """K3 at a GQA ratio above one launch's 8 query heads per kv head:
    ``check_decode``'s checks, and one launch per head group a call."""
    from repro_torch.kernels import decode_attention as da

    c = ops.COUNTERS["decode_attention"]
    before = c.launches
    check_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths)  # two calls
    groups = da.head_groups(Hq // Hkv)
    per_call = (c.launches - before) / 2
    log(f"    q_per_kv {Hq // Hkv}: {per_call:g} launches a call over head groups {groups}")
    if per_call != len(groups):
        raise PhaseFailed(f"decode_attention at q_per_kv {Hq // Hkv}: {per_call:g} launches a "
                          f"call, not {len(groups)}")


def measure_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths, iters=20, prior=False):
    """K3 checked and timed beside its plain version and SDPA; with
    ``prior``, its first, single-pass kernel too (checked, then timed as
    ``prior_ms``), launched explicitly on the same inputs."""
    from repro_torch.kernels import decode_attention as da

    (q, kc, vc, lens), err = check_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths)
    nbytes, flops = decode_work(B, Hq, Hkv, S, D, lengths, str(dtype))
    bound_ms, bound_by = bound(nbytes, flops, str(dtype))
    row = {
        "variant": da.variant(dtype, D),
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.decode_attention(q, kc, vc, lens), iters),
        "plain_ms": time_ms(lambda: ops.decode_attention_plain(q, kc, vc, lens), 3, 1),
        "library_ms": time_ms(sdpa_decode(q, kc, vc, lens), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    if prior:
        single = lambda: da.decode_attention(q, kc, vc, lens, kernel="single_pass")  # noqa: E731
        check_close("  its single-pass kernel", single(), ops.decode_attention_plain(q, kc, vc, lens),
                    str(dtype))
        row["prior_ms"] = time_ms(single, iters)
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} sdpa_ms={row['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})"
        + (f" prior_ms={row['prior_ms']:.4f} (single pass)" if prior else ""))
    return row


def decode_edge_lengths(S, B):
    """B lengths at K3's tile and split edges for a cache of S: 0, 1, 63, 64,
    65, either side of the first rank boundary of a full cache, S - 1, S."""
    from repro_torch.kernels import decode_attention as da

    edge = da.key_ranges(S, da.splits(S))[0][1]
    lens = [0, 1, 63, 64, 65, edge - 1, edge, edge + 1, S - 1, S]
    return (lens * (-(-B // len(lens))))[:B]


def check_softcap(ops, dev, gen):
    """An attention softcap goes to the plain version by the op's rule (as
    the reference's op sends it to its jnp path): the output equals the
    plain version's and no kernel launches."""
    import torch

    q, k, v = (torch.randn((1, 8, 300, 64), generator=gen, device=dev).to(torch.bfloat16)
               for _ in range(3))
    c = ops.COUNTERS["flash_attention"]
    launches, plain = c.launches, c.plain_calls
    got = ops.flash_attention(q, k, v, logit_softcap=30.0)
    want = ops.flash_attention_plain(q, k, v, logit_softcap=30.0)
    torch.cuda.synchronize()
    same = bool(torch.equal(got, want))
    log(f"  flash_attention bf16 (1, 8, 8, 300, 300, 64) logit_softcap=30.0 [route "
        f"{ops.flash_attention_route(True, 30.0)}]: equal to the plain version {same}, kernel "
        f"launches {c.launches - launches}, plain calls {c.plain_calls - plain}")
    if not same or c.launches != launches or c.plain_calls != plain + 2:
        raise PhaseFailed("flash_attention with a softcap: not the plain version's result, or "
                          "a kernel launched")


def phase_kernels(ops, dev, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.RandomState(seed)
    check_softcap(ops, dev, gen)
    for dtype in (torch.float32, torch.bfloat16):
        for S in (777, 1024):
            for window in (0, 512):
                measure_flash(ops, dev, gen, dtype, 1, 32, 32, S, S, 64, window)
        measure_flash(ops, dev, gen, dtype, 1, 28, 4, 777, 777, 128, 0)
        measure_flash(ops, dev, gen, dtype, 1, 32, 32, 64, 1024, 64, 0)           # suffix
        measure_flash(ops, dev, gen, dtype, 1, 32, 32, 64, 1024, 64, 0, q_offset=512)  # chunk
        for (B, Hq, Hkv, S, D) in ((16, 32, 32, 2048, 64), (16, 28, 4, 2048, 128)):
            lengths = [1, 2048] + list(rng.randint(1, 2049, size=B - 2))
            measure_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths, prior=True)
        # the other GQA ratios the kernels take (q_per_kv 2, 4, 8), both head
        # dims, a ragged sequence length and a length-0 decode row
        for g in (2, 4, 8):
            for D in (64, 128):
                measure_flash(ops, dev, gen, dtype, 2, 4 * g, 4, 300, 300, D, 64, iters=3)
                measure_decode(ops, dev, gen, dtype, 4, 4 * g, 4, 600, D, [0, 1, 333, 600],
                               iters=3)
        # K3's split and tile edges: lengths 0, 1, 63-65, either side of a rank
        # boundary, S - 1 and S, at every q_per_kv of 1, 2, 4, 7 and 8
        for S in (777, 2048):
            for g in (1, 2, 4, 7, 8):
                for D in (64, 128):
                    check_decode(ops, dev, gen, dtype, 10, 2 * g, 2, S, D,
                                 decode_edge_lengths(S, 10))
        # q_per_kv 12 and 16, more query heads per kv head than one launch
        # takes: the wrapper launches over two head groups a call
        for g in (12, 16):
            for S in (777, 2048):
                check_decode_groups(ops, dev, gen, dtype, 10, 2 * g, 2, S, 128,
                                    decode_edge_lengths(S, 10))
        # edges of the 64-row, 64-key tiles: lengths off the tile, fewer keys
        # than a tile, one query, runtime offsets with a window, GQA 7,
        # queries placed before every key, and no causal mask
        for D in (64, 128):
            check_flash(ops, dev, gen, dtype, 1, 4, 4, 40, 40, D, 0)
            check_flash(ops, dev, gen, dtype, 2, 8, 4, 100, 300, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 8, 2, 100, 300, D, 48, q_offset=150)
            check_flash(ops, dev, gen, dtype, 1, 28, 4, 300, 300, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 8, 8, 1, 777, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 4, 2, 70, 130, D, 0, q_offset=-20)
            check_flash(ops, dev, gen, dtype, 1, 4, 4, 200, 200, D, 0, causal=False)
        # head dims 112 (zamba2-7b) and 256 (paligemma-3b): K3 at its tile and
        # split edges at q_per_kv 1 and 8; K4 with lengths off the 64-row and
        # 64-key tiles, a window, runtime offsets and no causal mask
        for D in EXTRA_HEAD_DIMS:
            for S in (777, 2048):
                for g in (1, 8):
                    check_decode(ops, dev, gen, dtype, 10, 2 * g, 2, S, D,
                                 decode_edge_lengths(S, 10))
            check_flash(ops, dev, gen, dtype, 1, 8, 1, 777, 777, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 2, 2, 130, 130, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 8, 1, 777, 777, D, 512)
            check_flash(ops, dev, gen, dtype, 2, 8, 1, 100, 300, D, 0)
            check_flash(ops, dev, gen, dtype, 1, 8, 1, 100, 300, D, 48, q_offset=150)
            check_flash(ops, dev, gen, dtype, 1, 4, 2, 70, 130, D, 0, q_offset=-20)
            check_flash(ops, dev, gen, dtype, 1, 4, 4, 200, 200, D, 0, causal=False)


# ----------------------------------------------------------------- phase 2
# bf16 logits: both paths round each attention output to bf16 at the same
# place, but a float32 sum-order difference can land it one bf16 step
# (2^-8 relative) apart, and 24 residual layers carry such steps forward.
# Allow 5% of the largest logit; a wrong kernel (a wrong mask, head or
# position) moves logits by O(1) of it.
MODEL_RTOL = 5e-2
PROMPT_LEN = 777
DECODE_STEPS = 8
CACHE_LEN = 2048


def compare_logits(what, got, want):
    """Kernel-path logits against plain-path logits: within MODEL_RTOL of
    the largest |logit|; whether the argmax agrees is printed."""
    import torch

    got, want = got.float(), want.float()
    if got.shape != want.shape or not torch.isfinite(got).all():
        raise PhaseFailed(f"model {what}: shape {tuple(got.shape)} or non-finite logits")
    err = float((got - want).abs().max())
    lim = MODEL_RTOL * float(want.abs().max())
    agree = bool((got.argmax(-1) == want.argmax(-1)).all())
    log(f"  {what}: max_abs_err={err:.4f} limit={lim:.4f} (5% of max |logit|) "
        f"argmax_agree={agree} {'ok' if err <= lim else 'FAIL'}")
    if err > lim:
        raise PhaseFailed(f"model {what}: kernel path and plain path disagree")


def attention_layers(cfg) -> int:
    """Layers that run K4 in a prefill and K3 in a decode step: every block
    kind with attention (zamba2: its 13 shared-attention positions of 81;
    its Mamba2 layers run no kernel)."""
    from repro_torch.models.transformer import ATTENTION_BLOCKS

    return sum(k in ATTENTION_BLOCKS for k in cfg.layer_pattern)


def tree_params(params) -> int:
    """Parameters the model holds, counted from its tree (zamba2's
    ``cfg.param_count()`` counts per-head B/C projections it does not hold)."""
    from repro_torch.tree import tree_leaves

    return sum(t.numel() for t in tree_leaves(params))


def model_vs_plain(ops, cfg, dev, seed, prompt_len, decode_steps):
    """``cfg`` at full width (its dtype, seeded random weights): the kernel
    path's logits against the plain path's on the same weights, over a
    prefill of ``prompt_len`` tokens (for a stub frontend, seeded prefix
    embeddings take the first P positions) and ``decode_steps`` greedy
    decode steps. Fails unless K4 launched once per attention layer in the
    prefill and K3 once per attention layer per decode step, every launch
    the variant the wrapper's rule gives at the config's head dim."""
    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model

    t0 = time.perf_counter()
    model = build_model(cfg, device=dev)
    plain = build_model(cfg, device=dev, plain_kernels=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    nparams = tree_params(params)
    rng = np.random.RandomState(seed)
    tokens = torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(1, prompt_len)), device=dev)
    prefix, what = None, f"prefill {prompt_len} tokens"
    if cfg.num_prefix_embeddings:
        P, width = cfg.num_prefix_embeddings, cfg.frontend_embed_dim or cfg.d_model
        prefix = torch.as_tensor(rng.standard_normal((1, P, width)).astype(np.float32),
                                 device=dev)
        what = f"prefill {P} prefix embeddings ({width} wide) + {prompt_len - P} tokens"
    log(f"  {cfg.name} {cfg.dtype}: {nparams / 1e9:.3f}B params, {cfg.num_layers} layers, "
        f"d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}")
    ops.reset_counters()
    with torch.no_grad():
        lk, ck = model.forward_prefill(params, tokens, CACHE_LEN, prefix_embeds=prefix)
        lp, cp = plain.forward_prefill(params, tokens, CACHE_LEN, prefix_embeds=prefix)
        compare_logits(f"{cfg.name} {what}", lk, lp)
        lengths = torch.tensor([prompt_len], device=dev)
        for step in range(decode_steps):
            tok = lk.argmax(-1)  # both paths decode the same token
            lk, ck = model.forward_decode(params, tok, ck, lengths)
            lp, cp = plain.forward_decode(params, tok, cp, lengths)
            compare_logits(f"{cfg.name} decode step {step}", lk, lp)
            lengths = lengths + 1
    torch.cuda.synchronize()
    dtype, n_attn = model.dtype, attention_layers(cfg)
    for name, want, n in (
            ("flash_attention", fa.variant(dtype, cfg.head_dim), n_attn),
            ("decode_attention", da.variant(dtype, cfg.head_dim), n_attn * decode_steps)):
        by_variant = dict(ops.COUNTERS[name].variants)
        if by_variant != {want: n}:
            raise PhaseFailed(f"{cfg.name}: {name} launches {by_variant}, not {n} {want}")
    log(f"    kernel launches: flash_attention {n_attn} {fa.variant(dtype, cfg.head_dim)}, "
        f"decode_attention {n_attn * decode_steps} {da.variant(dtype, cfg.head_dim)} "
        f"(D={cfg.head_dim}, {n_attn} attention layers); {time.perf_counter() - t0:.1f} s")
    del params, ck, cp
    torch.cuda.empty_cache()


def phase_model(ops, dev, seed):
    from repro_torch.config import get_config

    model_vs_plain(ops, get_config("stablelm-1.6b"), dev, seed, PROMPT_LEN, DECODE_STEPS)


# ----------------------------------------------------------------- phase 3
R_TENANTS = 4
SLOTS = 4
REQUESTS = 16
MAX_NEW = 32


def run_engine(model, stacked, mode, prompts, ops, kernels):
    """Serve ``prompts`` in ``mode``; every kernel in ``kernels`` must launch.
    Returns (greedy tokens by request id, requests, launches in this run,
    the model's decode passes: one per merged step in space_time, one per
    tenant per step in time_only)."""
    import torch

    from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine

    eng = MultiTenantEngine(model, stacked_params=stacked, config=EngineConfig(
        num_tenants=R_TENANTS, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, mode=mode))
    reqs = [InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=MAX_NEW) for t, p in prompts]
    passes = [0]
    decode = model.forward_decode_tenants  # forward_decode runs through it too

    def counted(*args, **kwargs):
        passes[0] += 1
        return decode(*args, **kwargs)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: c.launches for k, c in ops.COUNTERS.items()}
    model.forward_decode_tenants = counted
    try:
        with torch.no_grad():
            for r in reqs:
                eng.submit(r)
            t0 = time.perf_counter()
            first = eng.step()  # admits (prefills) every request, then one decode step
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            eng.run_until_drained()
            torch.cuda.synchronize()
            t2 = time.perf_counter()
    finally:
        del model.forward_decode_tenants
    launches = {k: c.launches - before[k] for k, c in ops.COUNTERS.items()}
    rep = eng.report()
    done = [r for r in reqs if len(r.generated) == MAX_NEW]
    decode_tps = (eng.decode_tokens - first) / (t2 - t1)
    log(f"  {mode}: {len(eng.finished)}/{REQUESTS} finished, {len(done)} with {MAX_NEW} tokens; "
        f"steps={int(rep['steps'])} wall={t2 - t0:.3f}s")
    log(f"    decode tokens/s={decode_tps:.1f} decode p50={rep['p50_s'] * 1e3:.3f}ms "
        f"p95={rep['p95_s'] * 1e3:.3f}ms spread={rep['spread']:.4f} "
        f"prefill p50={rep['prefill_p50_s'] * 1e3:.3f}ms "
        f"max_memory_allocated={torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"    launches: " + " ".join(f"{k}={v}" for k, v in launches.items())
        + f" over {eng.steps} steps")
    if len(eng.finished) != REQUESTS or len(done) != REQUESTS:
        raise PhaseFailed(f"{mode}: not every request finished with {MAX_NEW} tokens")
    for k in kernels:
        if launches[k] <= 0:
            raise PhaseFailed(f"{mode}: kernel {k} was never launched on the serving path")
    tokens = {r.request_id: list(r.generated) for r in reqs}
    del eng
    return tokens, reqs, launches, passes[0]


def phase_serving(dev, seed, ops, arch, profile=False, flash_variant="wgmma"):
    """Phases 3, 6b and 7b: R_TENANTS tenants of ``arch`` served in both
    modes; returns (config, launches over both modes, per mode, prompt
    lengths). Fails unless every K4 launch took ``flash_variant``, once per
    attention layer per prefill in each mode, and every K3 launch split_kv,
    once per attention layer per decode pass of the model."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    stacked = stacked_tenants(model, dev, seed)
    seq_bytes = sum(t.numel() * t.element_size() for t in tree_leaves(
        model.init_caches(1, CACHE_LEN)))
    log(f"  caches: {seq_bytes / 1e6:.1f} MB a sequence at {CACHE_LEN} positions, "
        f"{R_TENANTS * SLOTS * seq_bytes / 1e9:.2f} GB for {R_TENANTS * SLOTS} slots")
    torch.cuda.empty_cache()
    prompts, lens = serve_prompts(cfg, seed)
    launches, per_mode, passes = serve_both_modes(model, stacked, prompts, ops, ATTENTION_KERNELS)
    for name, want in (("flash_attention", flash_variant), ("decode_attention", "split_kv")):
        by_variant = dict(ops.COUNTERS[name].variants)
        log(f"  {name} launches by variant on the serving path (D={cfg.head_dim}): {by_variant}")
        if by_variant.get(want, 0) != launches[name]:
            raise PhaseFailed(f"{name}: {launches[name]} launches on the serving path, not all "
                              f"{want}: {by_variant}")
    n_attn = attention_layers(cfg)
    for mode, per, n in zip(("space_time", "time_only"), per_mode, passes):
        if per["flash_attention"] != n_attn * REQUESTS:
            raise PhaseFailed(f"{mode}: flash_attention launched {per['flash_attention']} times, "
                              f"not {n_attn} per prefill")
        if per["decode_attention"] != n_attn * n:
            raise PhaseFailed(f"{mode}: decode_attention launched {per['decode_attention']} "
                              f"times in {n} decode passes, not {n_attn} per pass")
    log(f"  launches per mode: flash_attention {n_attn} attention layers x {REQUESTS} prefills; "
        f"decode_attention {n_attn} x {passes[0]} merged passes (space_time), x {passes[1]} "
        "per-tenant passes (time_only)")
    if profile:
        profile_serving(model, stacked, prompts)
    return cfg, launches, per_mode, lens


def stacked_tenants(model, dev, seed, init=None):
    """R_TENANTS tenants' seeded random weights, stacked; ``init(params,
    gen)`` (if given) runs on the stack after ``Model.init_stacked``."""
    import torch

    from repro_torch.core.tenancy import tenant_bytes

    gens = []
    for t in range(R_TENANTS):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 1 + t)
        gens.append(g)
    stacked = model.init_stacked(gens)
    if init is not None:
        init(stacked, gens[0])
    wbytes = tenant_bytes(stacked)
    log(f"  {R_TENANTS} tenants stacked: {wbytes / 1e9:.2f} GB of weights; merged decode "
        f"step weight-bytes bound {wbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    return stacked


def serve_prompts(cfg, seed):
    """REQUESTS (tenant, prompt) pairs, prompts of 128-1024 random tokens."""
    rng = np.random.RandomState(seed)
    lens = rng.randint(128, 1025, size=REQUESTS)
    prompts = [(i % R_TENANTS, rng.randint(1, cfg.vocab_size, size=int(n)).tolist())
               for i, n in enumerate(lens)]
    log(f"  prompts: lengths {sorted(int(x) for x in lens)}")
    return prompts, [int(x) for x in lens]


def serve_both_modes(model, stacked, prompts, ops, kernels):
    """The serving path's main run: counters zeroed just before, both modes,
    counters read just after. Returns (launches over both, per mode, the
    model's decode passes per mode)."""
    import torch

    ops.reset_counters()  # the main path starts here
    tok_st, reqs_st, per_st, passes_st = run_engine(model, stacked, "space_time", prompts, ops,
                                                    kernels)
    torch.cuda.empty_cache()
    tok_to, reqs_to, per_to, passes_to = run_engine(model, stacked, "time_only", prompts, ops,
                                                    kernels)
    launches = {k: c.launches for k, c in ops.COUNTERS.items()}
    plain_calls = {k: c.plain_calls for k, c in ops.COUNTERS.items()}
    if any(plain_calls.values()):
        raise PhaseFailed(f"plain versions were called on the serving path: {plain_calls}")
    same = sum(a == b for r1, r2 in zip(reqs_st, reqs_to)
               for a, b in zip(tok_st[r1.request_id], tok_to[r2.request_id]))
    log(f"  greedy-token agreement space_time vs time_only: {same}/{REQUESTS * MAX_NEW} "
        "(bf16: exact agreement not required)")
    log(f"  main-path launches (both modes): {launches}; plain-version calls: {plain_calls}")
    return launches, (per_st, per_to), (passes_st, passes_to)


def profile_serving(model, stacked, prompts, steps=8):
    """Where a decode step's time goes: torch.profiler over ``steps`` steady
    decode steps of each mode, after the first step has run every prefill.

    Prints the host wall time per step, the device time spent in kernels per
    step, the device's idle share (1 - kernel time / wall), the kernel
    launches per step, and the kernels that take the most device time.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine

    for mode in ("space_time", "time_only"):
        eng = MultiTenantEngine(model, stacked_params=stacked, config=EngineConfig(
            num_tenants=R_TENANTS, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, mode=mode))
        for t, p in prompts:
            eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=MAX_NEW))
        with torch.no_grad():
            eng.step()
            eng.step()
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                for _ in range(steps):
                    eng.step()
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        avgs = prof.key_averages()
        kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        n_kernels = sum(e.count for e in kernels)
        log(f"  profile {mode}: wall {wall / steps * 1e3:.3f} ms/step, kernels "
            f"{busy_us / steps / 1e3:.3f} ms/step, device idle share "
            f"{1 - busy_us / 1e6 / wall:.3f}, {n_kernels / steps:.0f} kernels/step")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]:
            log(f"    {e.self_device_time_total / steps / 1e3:8.3f} ms/step "
                f"{e.count / steps:6.0f}x  {e.key[:90]}")
        del eng
        torch.cuda.empty_cache()


def main_path_kernel_rows(ops, dev, seed, cfg, prompt_lens, launches, per_mode):
    """Kernel vs plain vs SDPA at a serving path's own shapes (bf16, ``cfg``'s
    heads and head dim): K3 at the merged decode step (space_time) and at
    one tenant's decode (time_only), each row with its mode's launches; K4
    at a median prefill. ``prior_ms`` is K3's first kernel (where it has an
    instance at the head dim) and K4's CUDA-core variant."""
    import torch

    from repro_torch.kernels import decode_attention as da

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 100)
    lens_mid = [n + MAX_NEW // 2 for n in prompt_lens]  # mid-generation cache lengths
    Hq, Hkv, D = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    prior = D in da.SINGLE_PASS_HEAD_DIMS
    log(f"  {cfg.name} decode_attention at the merged decode step: R*B={R_TENANTS * SLOTS}, "
        f"cache {CACHE_LEN}, lengths = prompt + {MAX_NEW // 2}")
    merged = measure_decode(ops, dev, gen, torch.bfloat16, R_TENANTS * SLOTS, Hq, Hkv, CACHE_LEN,
                            D, lens_mid, prior=prior)
    alone = lens_mid[::R_TENANTS]  # tenant 0's requests: prompts go to tenants in turn
    log(f"  {cfg.name} decode_attention at a time_only decode step: tenant 0 alone, B={SLOTS}, "
        f"lengths {alone}")
    single = measure_decode(ops, dev, gen, torch.bfloat16, SLOTS, Hq, Hkv, CACHE_LEN, D, alone,
                            prior=prior)
    s_med = int(np.median(prompt_lens))
    log(f"  {cfg.name} flash_attention at a median prefill: {s_med} tokens")
    fl = measure_flash(ops, dev, gen, torch.bfloat16, 1, Hq, Hkv, s_med, s_med, D, 0, prior=True)
    per_st, per_to = per_mode
    rows = []
    for name, shape, n, row in (
            ("decode_attention", "merged decode (space_time)", per_st["decode_attention"], merged),
            ("decode_attention", "one tenant's decode (time_only)", per_to["decode_attention"],
             single),
            ("flash_attention", "median prefill", launches["flash_attention"], fl)):
        row.setdefault("prior_ms", None)  # K3's first kernel has no instance at this D
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name], "shape": f"{cfg.name} {shape}, D={D}",
                     "launches": n, "launches_by_variant": {row["variant"]: n}, **row})
    return rows


# ----------------------------------------------------------------- phase 4
# The paper's GEMM super-kernel path: K1 batched_gemm and K2 grouped_gemm
# against their plain versions, the Table 1 strategy sweep, and the
# scheduler on two stochastic GEMM streams.
#
# Tolerances are the JAX kernel tests' own: K1 rtol 2e-4 (f32) / 2e-2
# (bf16) with atol = rtol * sqrt(K), the spread of a K-term float32 sum;
# K2 rtol 2e-4 / 3e-2 with atol = 10 * rtol. Both kernels compute in full
# float32 (no TF32), so only the order of the sums differs in f32.
GEMM_RTOL = {"torch.float32": 2e-4, "torch.bfloat16": 2e-2}
GROUPED_RTOL = {"torch.float32": 2e-4, "torch.bfloat16": 3e-2}
K1_CASES = [  # (R, M, K, N): tests/test_kernels_batched_gemm.py's shapes
    (2, 512, 512, 1), (4, 256, 1152, 128), (3, 256, 256, 256),
    (1, 128, 128, 128), (5, 100, 70, 33), (8, 16, 512, 16),
    (3, 200, 300, 96),  # the JAX block-shape-invariance problem
]
# K1's tile edges: row tiles (64 or 128 rows) ending inside a problem, K
# tails (8 = half a 16-deep stage; 2056 = 32 stages of 64 + 8) and N tails
# (40 inside one column tile, 5640 = 44 tiles + 8 columns)
K1_EDGE_CASES = [(3, m, 256, 136) for m in (1, 16, 100, 129, 300)] + [
    (2, 100, 8, 40), (2, 129, 2056, 5640), (3, 16, 2056, 40), (2, 300, 8, 5640)]
PAPER_RS = (2, 16, 120)
GROUP_SIZES = ([64, 64], [100, 5, 0, 260], [1, 1, 1], [300])
PAPER_GEOMEAN = {"rnn_matvec": 2.48, "resnet18_conv2_2": 3.23, "square_256": 4.93}
TABLE1_REPS = 5
ABLATION_TENANTS, ABLATION_TICKS = 8, 120   # examples/spacetime_ablation.py's trace
RAGGED_TENANTS, RAGGED_TICKS = 4, 40
RAGGED_K, RAGGED_N = 2048, 5632             # stablelm-1.6b: d_model, d_ff
WINDOW_S = 0.002
GEMM_MAX_CONNECTIONS = "32"  # hardware queues for space_only's 32 streams
GEMM_TIMEOUT_S = 600
GEMM_REPLACES = {
    "batched_gemm": "src/repro/kernels/batched_gemm.py:91",
    "grouped_gemm": "src/repro/kernels/grouped_gemm.py:92",
}


def gemm_tol(dtype, K):
    r = GEMM_RTOL[str(dtype)]
    return r, r * K ** 0.5


def grouped_tol(dtype):
    r = GROUPED_RTOL[str(dtype)]
    return r, 10 * r


def gemm_work(rows, K, N, w_mats, dtype):
    """(bytes, flops): x, w and out once each; 2*rows*K*N operations."""
    esize = 2 if "bfloat16" in str(dtype) else 4
    return esize * (rows * K + w_mats * K * N + rows * N), 2 * rows * K * N


def ragged_trace(seed):
    """Per tick, the (tenant, M) arrivals of the ragged stream: stablelm
    MLP-shaped GEMMs with M from decode batches (1-16 rows) and prefill
    chunks (128-1024 rows), half each."""
    rng = np.random.default_rng(seed + 7)
    ticks = []
    for _ in range(RAGGED_TICKS):
        arr = []
        for _ in range(1 + rng.poisson(1.0)):
            decode = rng.random() < 0.5
            m = int(rng.integers(1, 17)) if decode else int(rng.integers(128, 1025))
            arr.append((int(rng.integers(RAGGED_TENANTS)), m))
        ticks.append(arr)
    return ticks


def timed_row(err, kernel, plain, library, work, dtype, iters):
    """The kernels-line numbers of one kernel: its time, its plain
    version's and the library call's (CUDA events), and its bound."""
    bound_ms, bound_by = bound(*work, str(dtype))
    row = {
        "max_abs_err": err,
        "ms": time_ms(kernel, iters),
        "plain_ms": time_ms(plain, 3, 1),
        "library_ms": time_ms(library, iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} bmm_ms={row['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by}) kernel/bmm={row['ms'] / row['library_ms']:.2f}")
    return row


def measure_batched(ops, x, w, err, iters=20):
    """K1 timed beside its plain version and torch.bmm, then its first,
    CUDA-core kernel (checked, then timed as ``prior_ms``), launched
    explicitly on the same inputs."""
    import torch

    from repro_torch.kernels import batched_gemm as bg

    R, M, K = x.shape
    N = w.shape[2]
    row = {"variant": bg.variant(x.dtype, K, N)}
    row.update(timed_row(err, lambda: ops.batched_gemm(x, w), lambda: ops.batched_gemm_plain(x, w),
                         lambda: torch.bmm(x, w), gemm_work(R * M, K, N, R, x.dtype), x.dtype,
                         iters))
    prior = lambda: bg.batched_gemm(x, w, kernel="cuda_core")  # noqa: E731
    check_close("  its CUDA-core kernel", prior(), ops.batched_gemm_plain(x, w), str(x.dtype),
                gemm_tol(x.dtype, K))
    row["prior_ms"] = time_ms(prior, iters)
    log(f"    prior_ms={row['prior_ms']:.4f} (first CUDA-core kernel) prior/kernel="
        f"{row['prior_ms'] / row['ms']:.2f}")
    return row


def measure_grouped(ops, x, w, bg, bm, err, iters=10):
    """K2 timed beside its plain version and torch.bmm, then its CUDA-core
    variant (checked, then timed as ``prior_ms``), launched explicitly on
    the same inputs."""
    import torch

    from repro_torch.kernels import grouped_gemm as gg

    T, K = x.shape
    wg = w[torch.as_tensor(bg, device=w.device).long()]  # gathered outside the timing
    xb = x.view(T // bm, bm, K)
    used = len(np.unique(bg))  # w counts once per group the blocks use
    row = {"variant": gg.variant(x.dtype, K, w.shape[2])}
    row.update(timed_row(err, lambda: ops.grouped_gemm(x, w, bg, bm=bm),
                         lambda: ops.grouped_gemm_plain(x, w, bg, bm=bm),
                         lambda: torch.bmm(xb, wg), gemm_work(T, K, w.shape[2], used, x.dtype),
                         x.dtype, iters))
    check_close("  its CUDA-core variant", gg.grouped_gemm(x, w, bg, bm, kernel="cuda_core"),
                ops.grouped_gemm_plain(x, w, bg, bm=bm), str(x.dtype), grouped_tol(x.dtype))
    row["prior_ms"] = time_ms(lambda: gg.grouped_gemm(x, w, bg, bm, kernel="cuda_core"), iters)
    log(f"    prior_ms={row['prior_ms']:.4f} (CUDA cores) prior/kernel="
        f"{row['prior_ms'] / row['ms']:.2f}")
    return row


def check_batched(ops, gen, dev, dtype, R, M, K, N):
    import torch

    from repro_torch.kernels import batched_gemm as bg

    x = torch.randn((R, M, K), generator=gen, device=dev).to(dtype)
    w = torch.randn((R, K, N), generator=gen, device=dev).to(dtype)
    got = ops.batched_gemm(x, w)
    want = ops.batched_gemm_plain(x, w)
    torch.cuda.synchronize()
    err = check_close(f"batched_gemm {str(dtype)[6:]} {(R, M, K, N)} [{bg.variant(dtype, K, N)}]",
                      got, want, str(dtype), gemm_tol(dtype, K))
    return x, w, err


def check_independence(ops, gen, dev, dtype, M, K, N):
    """Four problems; changing x[2] must leave problems 0, 1 and 3
    bit-identical."""
    import torch

    from repro_torch.kernels import batched_gemm as bg

    x = torch.randn((4, M, K), generator=gen, device=dev).to(dtype)
    w = torch.randn((4, K, N), generator=gen, device=dev).to(dtype)
    base = ops.batched_gemm(x, w)
    x2 = x.clone()
    x2[2] = torch.randn((M, K), generator=gen, device=dev).to(dtype)
    pert = ops.batched_gemm(x2, w)
    same = [bool(torch.equal(base[r], pert[r])) for r in range(4)]
    log(f"  batched_gemm {str(dtype)[6:]} {(4, M, K, N)} [{bg.variant(dtype, K, N)}] problem "
        f"independence: bit-identical per problem after changing x[2]: {same}")
    if same != [True, True, False, True]:
        raise PhaseFailed("batched_gemm: a problem's output depends on another's data")


def group_inputs(gen, dev, dtype, sizes, bm, K, N):
    import torch

    from repro_torch.kernels.grouped_gemm import make_group_layout

    offs, bg, T = make_group_layout(np.asarray(sizes), bm=bm)
    x = torch.zeros((T, K), device=dev)
    for g, sz in enumerate(sizes):
        x[offs[g]:offs[g] + sz] = torch.randn((sz, K), generator=gen, device=dev)
    w = torch.randn((len(sizes), K, N), generator=gen, device=dev)
    return x.to(dtype), w.to(dtype), bg


def check_grouped(ops, name, dtype, x, w, bg, bm):
    import torch

    from repro_torch.kernels import grouped_gemm as gg

    got = ops.grouped_gemm(x, w, bg, bm=bm)
    want = ops.grouped_gemm_plain(x, w, bg, bm=bm)
    torch.cuda.synchronize()
    kind = gg.variant(dtype, x.shape[1], w.shape[2])
    return check_close(f"{name} [{kind}]", got, want, str(dtype), grouped_tol(dtype))


def phase_gemm_kernels(ops, dev, seed):
    """(a) K1 and K2 against their plain versions, f32 and bf16; times at
    the Table 1 shapes."""
    import torch

    from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 4)
    ragged_sizes = [m for tick in ragged_trace(seed) for _, m in tick][:8]
    for dtype in (torch.float32, torch.bfloat16):
        for case in K1_CASES:
            check_batched(ops, gen, dev, dtype, *case)
        for g in PAPER_GEMM_SHAPES.values():
            for R in PAPER_RS:
                x, w, err = check_batched(ops, gen, dev, dtype, R, g.M, g.K, g.N)
                if dtype == torch.float32:  # Table 1 is float32
                    measure_batched(ops, x, w, err)
        for case in K1_EDGE_CASES:
            check_batched(ops, gen, dev, dtype, *case)
        # bitwise problem independence: changing x[2] leaves 0, 1, 3 as they
        # were; at M = 100 a 128-row wgmma tile reads the next problem's rows,
        # and at K = 1152 the simt kernel splits K over a cluster of 4
        for M, K, N in ((64, 64, 64), (100, 1152, 136)):
            check_independence(ops, gen, dev, dtype, M, K, N)
        tag = str(dtype)[6:]
        # bm against the 64-row (CUDA cores) and 128-row (wgmma) tiles: 96 is
        # 1.5 of the one, 256 two of the other; K 48 and N 40 are tails
        # inside one 64-deep stage and one 128-wide tile
        for sizes in GROUP_SIZES:
            for bm in (32, 96, 128, 256):
                x, w, bg = group_inputs(gen, dev, dtype, sizes, bm, 48, 40)
                check_grouped(ops, f"grouped_gemm {tag} sizes={sizes} bm={bm}",
                              dtype, x, w, bg, bm)
        # K and N tails at full width: K 2056 = 32 stages + 8, N 5640 = 44
        # tiles + 8 columns; and an N that only the CUDA-core kernel takes
        for sizes, bm, K, N in (([300, 17, 130], 128, 2056, 5640), ([100, 5, 0, 260], 96, 2056, 40),
                                ([100, 5, 0, 260], 96, 48, 5640), ([100, 5, 0, 260], 32, 72, 33)):
            x, w, bg = group_inputs(gen, dev, dtype, sizes, bm, K, N)
            check_grouped(ops, f"grouped_gemm {tag} sizes={sizes} bm={bm} K={K} N={N}",
                          dtype, x, w, bg, bm)
        # a tail of zero blocks and zero weights, as SuperKernelCache.ragged_layout pads them
        check_ragged_tail(ops, gen, dev, dtype, [300, 17, 5], 256, 136)
        x, w, bg = group_inputs(gen, dev, dtype, ragged_sizes, 128, RAGGED_K, RAGGED_N)
        check_grouped(ops, f"grouped_gemm {str(dtype)[6:]} sizes={ragged_sizes} bm=128 "
                      f"K={RAGGED_K} N={RAGGED_N}", dtype, x, w, bg, 128)
        # group isolation: rows of group g see only w[g]; padded rows are 0
        x, w, bg = group_inputs(gen, dev, dtype, [16, 9], 16, 24, 8)
        out = ops.grouped_gemm(x, w, bg, bm=16).float()
        x32, w32 = x.float(), w.float()
        want = torch.cat([x32[:16] @ w32[0], x32[16:] @ w32[1]])
        check_close(f"grouped_gemm {str(dtype)[6:]} group isolation", out, want,
                    str(dtype), grouped_tol(dtype))
        if not torch.equal(out[25:], torch.zeros_like(out[25:])):
            raise PhaseFailed("grouped_gemm: padded rows are not zero")


def check_ragged_tail(ops, gen, dev, dtype, sizes, K, N):
    """K2 on the layout ``execute_ragged`` builds for ``sizes``: rows packed
    at their offsets, padded to a pow2 bucket of row blocks (group 0, zero
    rows) and a pow2 bucket of groups (zero weights). The tail rows must be
    0."""
    import torch

    from repro_torch.config import ScheduleConfig
    from repro_torch.core import SuperKernelCache
    from repro_torch.core.superkernel import RAGGED_BM

    offs, T, bg, G = SuperKernelCache(ScheduleConfig()).ragged_layout(sizes)
    x = torch.zeros((T, K), device=dev)
    for o, m in zip(offs, sizes):
        x[int(o):int(o) + m] = torch.randn((m, K), generator=gen, device=dev)
    w = torch.zeros((G, K, N), device=dev)
    w[: len(sizes)] = torch.randn((len(sizes), K, N), generator=gen, device=dev)
    x, w = x.to(dtype), w.to(dtype)
    check_grouped(ops, f"grouped_gemm {str(dtype)[6:]} ragged_layout({sizes}): T={T}, "
                  f"{len(bg)} blocks, G={G}", dtype, x, w, bg, RAGGED_BM)
    out = ops.grouped_gemm(x, w, bg, bm=RAGGED_BM)
    tail = int(offs[-1])
    if not torch.equal(out[tail:], torch.zeros_like(out[tail:])):
        raise PhaseFailed("grouped_gemm: rows of the padded tail blocks are not zero")


def phase_table1(ops, dev, seed):
    """(b) Table 1 on the card: four strategies, f32, reps 5, min time."""
    import torch

    from repro_torch.config import ScheduleConfig
    from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES, PAPER_R_SWEEP
    from repro_torch.core import GemmProblem, SuperKernelCache
    from repro_torch.core.strategies import Exclusive, SpaceOnly, SpaceTime, TimeOnly
    from repro_torch.kernels import ref

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 5)
    log(f"  {'shape':18s} {'R':>4s} | GFLOP/s {'time_only':>10s} {'space_only':>10s} "
        f"{'space_time':>10s} {'exclusive':>10s} | st/space st/time")
    for name, g in PAPER_GEMM_SHAPES.items():
        vs_space, vs_time = [], []
        for r in PAPER_R_SWEEP:
            problems = [GemmProblem(tenant_id=t,
                                    x=torch.randn((g.M, g.K), generator=gen, device=dev),
                                    w=torch.randn((g.K, g.N), generator=gen, device=dev))
                        for t in range(r)]
            rates = {}
            for s in (TimeOnly(), SpaceOnly(),
                      SpaceTime(SuperKernelCache(ScheduleConfig(r_bucketing="exact"))),
                      Exclusive()):
                s.prepare(problems)
                times = []
                for _ in range(TABLE1_REPS):
                    outs, t = s.run()
                    times.append(t)
                rates[s.name] = g.flops * r / min(times)
                if r == 16:  # every strategy's outputs, once, against the plain product
                    ws = [problems[0].w if s.name == "exclusive" else p.w for p in problems]
                    want = ref.batched_gemm(torch.stack([p.x for p in problems]),
                                            torch.stack(ws))
                    check_close(f"{name} R=16 {s.name}", torch.stack(outs), want,
                                "torch.float32", gemm_tol(torch.float32, g.K))
            vs_space.append(rates["space_time"] / rates["space_only"])
            vs_time.append(rates["space_time"] / rates["time_only"])
            log(f"  {name:18s} {r:4d} | {'':7s} " + " ".join(
                f"{rates[k] / 1e9:10.1f}" for k in ("time_only", "space_only", "space_time",
                                                    "exclusive"))
                + f" | {vs_space[-1]:7.2f}x {vs_time[-1]:6.2f}x")
            del problems
        log(f"  {name:18s} geomean over R: st/space_only {geomean(vs_space):.2f}x "
            f"st/time_only {geomean(vs_time):.2f}x (paper geomean vs next-best: "
            f"{PAPER_GEOMEAN[name]:.2f}x)")


def geomean(xs):
    return float(np.exp(np.mean(np.log(xs))))


def run_gemm_stream(ops, sched, ticks, make_problem):
    """Drive ``sched`` on a WallClock over ``ticks`` (lists of arrival
    specs), as examples/spacetime_ablation.py does; returns the completed
    problems and each op's (launches, plain calls), zeroed just before the
    run and read just after."""
    import torch

    done = []
    torch.cuda.synchronize()
    ops.reset_counters()
    for arrivals in ticks:
        for spec in arrivals:
            sched.submit(make_problem(spec))
        done.extend(sched.pump())
        time.sleep(0.0002)
    done.extend(sched.flush())
    torch.cuda.synchronize()
    counts = {k: (c.launches, c.plain_calls, dict(c.variants)) for k, c in ops.COUNTERS.items()}
    return done, counts


def report_stream(what, sched, done, n_submitted, counts, tol_of):
    """Check every completed problem against its plain product; print the
    run's metrics."""
    import torch

    from repro_torch.kernels import ref

    if len(done) != n_submitted or any(p.result is None for p in done):
        raise PhaseFailed(f"{what}: {len(done)}/{n_submitted} problems completed")
    worst, bad = 0.0, 0
    for p in done:
        rtol, atol = tol_of(p)
        want = ref.batched_gemm(p.x[None], p.w[None])[0].float()
        got = p.result.float()
        if got.shape != want.shape or not torch.isfinite(got).all():
            raise PhaseFailed(f"{what}: result of shape {tuple(got.shape)} or non-finite")
        err = (got - want).abs()
        worst = max(worst, float(err.max()))
        bad += int((err > atol + rtol * want.abs()).any())
    lat = np.asarray([p.completion_time - p.arrival_time for p in done])
    rep = sched.report()
    log(f"  {what}: {len(done)} problems, dispatches={int(rep['dispatches'])}, "
        f"cache_hit_rate={rep['cache_hit_rate']:.3f}, achieved_tflops={rep['achieved_tflops']:.3f}, "
        f"latency p50={np.percentile(lat, 50) * 1e3:.3f}ms p95={np.percentile(lat, 95) * 1e3:.3f}ms, "
        f"cache {sched.cache.stats}")
    log(f"    results vs plain product: max_abs_err={worst:.3e}, {bad} out of tolerance; "
        f"launches/plain calls: {counts}")
    if bad:
        raise PhaseFailed(f"{what}: {bad} results out of tolerance")


def ablation_stream(dev, seed):
    """Run 1's stream, examples/spacetime_ablation.py's trace: 8 tenants'
    conv2_2 GEMMs (f32), 1 + Poisson(1.5) arrivals per tick, 120 ticks.
    Returns (ticks of (tenant, input) specs, spec -> GemmProblem)."""
    import torch

    from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES
    from repro_torch.core import GemmProblem

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 6)
    g = PAPER_GEMM_SHAPES["resnet18_conv2_2"]
    rng = np.random.default_rng(seed)
    ws = [torch.randn((g.K, g.N), generator=gen, device=dev) for _ in range(ABLATION_TENANTS)]
    xs = [torch.randn((g.M, g.K), generator=gen, device=dev) for _ in range(4)]
    ticks = [[(int(rng.integers(ABLATION_TENANTS)), int(rng.integers(4)))
              for _ in range(1 + rng.poisson(1.5))] for _ in range(ABLATION_TICKS)]
    return ticks, lambda s: GemmProblem(tenant_id=s[0], x=xs[s[1]], w=ws[s[0]])


def ragged_stream(dev, seed):
    """Run 2's stream: ``ragged_trace``'s arrivals of stablelm-1.6b MLP
    GEMMs (bf16) from 4 tenants. Returns (ticks, spec -> GemmProblem)."""
    import torch

    from repro_torch.core import GemmProblem

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 7)
    wr = [torch.randn((RAGGED_K, RAGGED_N), generator=gen, device=dev).to(torch.bfloat16)
          for _ in range(RAGGED_TENANTS)]
    return ragged_trace(seed), lambda s: GemmProblem(
        tenant_id=s[0], w=wr[s[0]],
        x=torch.randn((s[1], RAGGED_K), generator=gen, device=dev).to(torch.bfloat16))


def phase_gemm_scheduler(ops, dev, seed):
    """(c) DynamicSpaceTimeScheduler on two stochastic GEMM streams."""
    import torch

    from repro_torch.config import ScheduleConfig
    from repro_torch.core import DynamicSpaceTimeScheduler

    # run 1: the ablation trace
    ticks, make_problem = ablation_stream(dev, seed)
    sizes1 = []
    sched = DynamicSpaceTimeScheduler(
        ScheduleConfig(batching_window_s=WINDOW_S, max_superkernel_size=64),
        on_dispatch=lambda batch, dt, rid: sizes1.append(len(batch)))
    done, counts1 = run_gemm_stream(ops, sched, ticks, make_problem)
    K = done[0].x.shape[1]
    report_stream(f"run 1: {ABLATION_TENANTS} tenants resnet18_conv2_2 f32, window "
                  f"{WINDOW_S * 1e3:g} ms", sched, done, sum(map(len, ticks)), counts1,
                  lambda p: gemm_tol(torch.float32, K))
    log(f"    dispatch sizes R: {sizes1}")
    del done, sched

    # run 2: ragged merge at stablelm-1.6b's MLP width, bf16
    ticks, make_problem = ragged_stream(dev, seed)
    layouts = []
    sched = DynamicSpaceTimeScheduler(
        ScheduleConfig(batching_window_s=WINDOW_S, max_superkernel_size=64,
                       allow_ragged_merge=True),
        on_dispatch=lambda batch, dt, rid: layouts.append([p.x.shape[0] for p in batch]))
    done, counts2 = run_gemm_stream(ops, sched, ticks, make_problem)
    report_stream(f"run 2: {RAGGED_TENANTS} tenants ragged K={RAGGED_K} N={RAGGED_N} bf16",
                  sched, done, sum(map(len, ticks)), counts2,
                  lambda p: gemm_tol(torch.bfloat16, RAGGED_K))
    log(f"    dispatch row counts: {layouts}")
    del done
    if counts1["batched_gemm"][0] <= 0:
        raise PhaseFailed("run 1 never launched batched_gemm")
    if counts2["grouped_gemm"][0] <= 0:
        raise PhaseFailed("run 2 never launched grouped_gemm")
    # every launch of the path on the kernel its dtype and shape route to:
    # run 1 (f32) K1 on simt; run 2 (bf16, K and N multiples of 8) K1 and K2
    # on wgmma
    for run, counts, name, want in (("run 1", counts1, "batched_gemm", "simt"),
                                    ("run 2", counts2, "batched_gemm", "wgmma"),
                                    ("run 2", counts2, "grouped_gemm", "wgmma")):
        by_variant = counts[name][2]
        log(f"    {run} {name} launches by variant: {by_variant}")
        if by_variant.get(want, 0) != counts[name][0]:
            raise PhaseFailed(f"{run}: {name} launches not all {want}: {by_variant}")
    plain = {k: counts1[k][1] + counts2[k][1] for k in GEMM_REPLACES}
    if any(plain.values()):
        raise PhaseFailed(f"plain versions were called on the GEMM path: {plain}")
    # each ragged dispatch's sizes and the layout its cache launched K2 on;
    # each dispatch of one row count, which the cache launched K1 on
    ragged = [(l, sched.cache.ragged_layout(l)) for l in layouts if len(set(l)) > 1]
    single = [l for l in layouts if len(set(l)) == 1]
    return (counts1, counts2), sizes1, ragged, single


def gemm_path_kernel_rows(ops, dev, seed, counts, sizes1, ragged, single):
    """K1 and K2 against plain and torch.bmm at the scheduler runs' shapes:
    K1 at run 1's median dispatch (R padded to its pow2 bucket, f32) and at
    run 2's median dispatch of one row count (bf16), K2 at run 2's median
    ragged dispatch (by padded rows), on the layout the cache launched it on.
    Each row's launches are its run's."""
    import torch

    from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES
    from repro_torch.core import round_pow2
    from repro_torch.core.superkernel import RAGGED_BM

    counts1, counts2 = counts
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 8)
    g = PAPER_GEMM_SHAPES["resnet18_conv2_2"]
    R = round_pow2(int(np.median(sizes1)))
    log(f"  batched_gemm at run 1's median dispatch: R={R} (pow2 bucket), {g.name} f32")
    x, w, err = check_batched(ops, gen, dev, torch.float32, R, g.M, g.K, g.N)
    k1 = measure_batched(ops, x, w, err)
    if single:
        by_work = sorted(single, key=lambda l: round_pow2(len(l)) * l[0])
        sizes = by_work[len(by_work) // 2]
        R, M = round_pow2(len(sizes)), sizes[0]
        log(f"  batched_gemm at run 2's median dispatch of one row count: {len(sizes)} x M={M} "
            f"-> R={R} (pow2 bucket), K={RAGGED_K} N={RAGGED_N} bf16")
    else:  # no dispatch of one row count happened: a decode-sized problem alone
        R, M = 1, int(np.median([m for tick in ragged_trace(seed) for _, m in tick if m <= 16]))
        log(f"  run 2 made no dispatch of one row count; batched_gemm bf16 at R=1, M={M}")
    x, w, err = check_batched(ops, gen, dev, torch.bfloat16, R, M, RAGGED_K, RAGGED_N)
    k1b = measure_batched(ops, x, w, err)
    by_rows = sorted(ragged, key=lambda r: r[1][1])
    sizes, (offs, T, bg, G) = by_rows[len(by_rows) // 2]
    log(f"  grouped_gemm at run 2's median ragged dispatch: M={sizes} -> T={T} rows, "
        f"{G} groups (pow2), bf16")
    x = torch.zeros((T, RAGGED_K), device=dev)
    for o, m in zip(offs, sizes):
        x[int(o):int(o) + m] = torch.randn((m, RAGGED_K), generator=gen, device=dev)
    x = x.to(torch.bfloat16)
    w = torch.zeros((G, RAGGED_K, RAGGED_N), device=dev, dtype=torch.bfloat16)
    w[: len(sizes)] = torch.randn((len(sizes), RAGGED_K, RAGGED_N), generator=gen,
                                  device=dev).to(torch.bfloat16)
    err = check_grouped(ops, "grouped_gemm bf16 at that layout", torch.bfloat16, x, w, bg,
                        RAGGED_BM)
    k2 = measure_grouped(ops, x, w, bg, RAGGED_BM, err)
    rows = []
    for name, shape, cnt, row in (
            ("batched_gemm", "run 1's median dispatch, f32", counts1["batched_gemm"], k1),
            ("batched_gemm", "run 2's median dispatch of one row count, bf16",
             counts2["batched_gemm"], k1b),
            ("grouped_gemm", "run 2's median ragged dispatch, bf16", counts2["grouped_gemm"], k2)):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": GEMM_REPLACES[name], "shape": shape, "launches": cnt[0],
                     "launches_by_variant": cnt[2], **row})
    return rows


def profile_gemm_stream(ops, dev, seed):
    """Where a merged GEMM dispatch's time goes: torch.profiler over run 1's
    stream (K1) and run 2's (K2). Prints the mean dispatch time (the
    scheduler's busy time over its dispatches), the device's kernel time per
    dispatch, its idle share over the run (the stream sleeps 0.2 ms per
    tick), and the kernels and host ops that take the most time. Profiled
    times include the profiler's own cost."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import ScheduleConfig
    from repro_torch.core import DynamicSpaceTimeScheduler

    for run, (ticks, make_problem), ragged in (("run 1", ablation_stream(dev, seed), False),
                                               ("run 2", ragged_stream(dev, seed), True)):
        sched = DynamicSpaceTimeScheduler(
            ScheduleConfig(batching_window_s=WINDOW_S, max_superkernel_size=64,
                           allow_ragged_merge=ragged))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run_gemm_stream(ops, sched, ticks, make_problem)
            wall = time.perf_counter() - t0
        n = sched.stats.dispatches
        avgs = prof.key_averages()
        kernels = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_us = sum(e.self_device_time_total for e in kernels)
        log(f"  profile {run}: wall {wall * 1e3:.3f} ms, {n} dispatches, mean dispatch "
            f"{sched.stats.busy_time_s / n * 1e3:.3f} ms (scheduler busy time), device kernels "
            f"{busy_us / n / 1e3:.3f} ms per dispatch, device idle share "
            f"{1 - busy_us / 1e6 / wall:.3f}")
        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
            log(f"    device {e.self_device_time_total / n / 1e3:8.3f} ms/dispatch "
                f"{e.count / n:5.1f}x  {e.key[:80]}")
        host = [e for e in avgs if e.device_type == torch.autograd.DeviceType.CPU]
        for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:10]:
            log(f"    host   {e.self_cpu_time_total / n / 1e3:8.3f} ms/dispatch "
                f"{e.count / n:5.1f}x  {e.key[:80]}")
        del sched
        torch.cuda.empty_cache()


def phase_gemm(ops, dev, seed, profile=False):
    import torch

    log(" (a) K1 batched_gemm and K2 grouped_gemm against their plain versions")
    phase_gemm_kernels(ops, dev, seed)
    log(" (b) Table 1 on the card: four strategies, float32, min of "
        f"{TABLE1_REPS} runs, GFLOP/s")
    ops.reset_counters()
    phase_table1(ops, dev, seed)
    counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTERS.items()}
    log(f"  launches / plain calls over the sweep: {counts}")
    if any(counts[k][1] for k in GEMM_REPLACES):
        raise PhaseFailed(f"plain versions were called in the Table 1 sweep: {counts}")
    torch.cuda.empty_cache()
    log(" (c) the scheduler on stochastic GEMM streams (WallClock)")
    counts, sizes1, ragged, single = phase_gemm_scheduler(ops, dev, seed)
    log(f"  GEMM path launches (run 1; run 2): "
        f"{ {k: counts[0][k][0] for k in GEMM_REPLACES} }; "
        f"{ {k: counts[1][k][0] for k in GEMM_REPLACES} }")
    log("kernels at the GEMM path's shapes")
    rows = gemm_path_kernel_rows(ops, dev, seed, counts, sizes1, ragged, single)
    if profile:
        profile_gemm_stream(ops, dev, seed)
    return rows


def phase_gemm_apart(seed, profile):
    """Phase 4 in a child process with CUDA_DEVICE_MAX_CONNECTIONS set (it
    reuses the kernels this run built); returns its kernels rows."""
    with tempfile.TemporaryDirectory() as tmp:
        rows_file = Path(tmp) / "rows.json"
        cmd = [sys.executable, str(Path(__file__).resolve()), "--phases", "4",
               "--seed", str(seed), "--rows-out", str(rows_file)]
        env = dict(os.environ, CUDA_DEVICE_MAX_CONNECTIONS=GEMM_MAX_CONNECTIONS)
        try:
            rc = subprocess.run(cmd + (["--profile"] if profile else []), env=env,
                                timeout=GEMM_TIMEOUT_S).returncode
        except subprocess.TimeoutExpired:
            raise PhaseFailed(f"phase 4 took more than {GEMM_TIMEOUT_S} s") from None
        if rc != 0:
            raise PhaseFailed(f"phase 4 exited with {rc}")
        return json.loads(rows_file.read_text())


# ----------------------------------------------------------------- phase 5
# The RWKV-6 serving path: K5 wkv6_scan against its plain version, the
# full-width model, and four rwkv6-1.6b tenants through the engine.
#
# K5 tolerances. The final state is float32 in both versions, from the
# same inputs; only the order of float32 sums differs, over a 64-term dot
# and T steps of an accumulating state: the JAX kernel test's own rtol
# 2e-4, atol 2e-3, in both dtypes. Outputs: that in f32; in bf16 both
# round the same float32 value once, so TOL's bf16 (2e-2, 2e-2) covers a
# flipped rounding step.
RWKV = "rwkv6-1.6b"
WKV_TOL = (2e-4, 2e-3)
WKV_HEADS, WKV_N = 32, 64                # rwkv6-1.6b: H heads of N = V = 64
WKV_TS = (1, 17, 128, 777, 1024)
CHUNK_SPLIT = 512                        # chunked prefills: 777 = 512 + 265
# decay logits w ~ N(mean, std) besides the default N(-3, 1): strong decay
# (products of 16 decays underflow to 0 inside a chunk) and weak (d ~ 0.9997)
WKV_DECAYS = {"strong": (1.0, 1.0), "weak": (-8.0, 0.5)}
LORA_B_SCALE = 0.1                       # w_lora_b std: a data-dependent decay


def live_decay_(params, gen):
    """Random w_lora_b in every RWKV layer. At the JAX init it is zero, so
    the decay is the constant exp(-exp(-4)) and K5's per-token decay would
    go untested; a trained model's is data-dependent."""
    from repro_torch.models import layers

    for lp in params["layers"]:
        layers.normal_(lp["w_lora_b"], LORA_B_SCALE, gen)


def wkv_inputs(gen, dev, dtype, T, w_dtype=None, w_mean=-3.0, w_std=1.0):
    """r, k, v, w as the serving path hands them to K5: (1, T, H, N)
    projections read as (1, H, T, N) views; r, k, v ~ 0.5 N(0, 1) and decay
    logits w ~ N(w_mean, w_std) (by default decays from 0.37 to 0.998); u
    (H, N) ~ 0.3 N(0, 1)."""
    import torch

    shape = (1, T, WKV_HEADS, WKV_N)

    def proj(scale, shift=0.0, dt=dtype):
        t = torch.randn(shape, generator=gen, device=dev) * scale + shift
        return t.to(dt).transpose(1, 2)

    r, k, v = proj(0.5), proj(0.5), proj(0.5)
    w = proj(w_std, w_mean, w_dtype or dtype)
    u = torch.randn((WKV_HEADS, WKV_N), generator=gen, device=dev) * 0.3
    return r, k, v, w, u


def wkv_work(T, dtype, w_dtype=None):
    """(bytes, float32 flops) of one scan over WKV_HEADS heads: r, k, v, w
    read and out written once, u, the initial state read and the final state
    written once; ~5 N V flops per head per step (o: r S and the bonus,
    S: decay S + k v)."""
    esize = 2 if "bfloat16" in str(dtype) else 4
    wsize = 4 if w_dtype is not None and "float32" in str(w_dtype) else esize
    bh, n = WKV_HEADS, WKV_N
    nbytes = bh * T * n * (4 * esize + wsize) + 4 * bh * n + 2 * 4 * bh * n * n
    return nbytes, 5 * n * n * bh * T


def check_wkv(ops, name, dtype, inputs, s0, kernel=None):
    """K5 (``variant``'s kernel, or ``kernel`` launched directly) against
    its plain version on one case; returns (max error, out, final state)."""
    import torch

    from repro_torch.kernels import wkv6_scan as wk

    kind = kernel or wk.variant(dtype, inputs[0].shape[-2])
    if kernel is None:
        got, gs = ops.wkv6_scan(*inputs, init_state=s0)
    else:
        got, gs = wk.wkv6_scan(*inputs, init_state=s0, kernel=kernel)
    want, ws = ops.wkv6_scan_plain(*inputs, init_state=s0)
    torch.cuda.synchronize()
    out_tol = WKV_TOL if dtype == torch.float32 else None
    err = check_close(f"{name} [{kind}] out", got, want, str(dtype), out_tol)
    check_close(f"{name} [{kind}] final state", gs, ws, "torch.float32", WKV_TOL)
    return err, got, gs


def phase_wkv_kernel(ops, dev, seed):
    """(a) K5 against its plain version: f32 and bf16, every T of WKV_TS,
    from a zero and a random state; a 777-step scan against 512 steps then
    265 from the carried state (in one buffer, as the model's cache); strong
    and weak decay at T = 777; the (BH, T, N) form and a float32 w beside
    bf16 r, k, v."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 9)
    for dtype in (torch.float32, torch.bfloat16):
        tag = str(dtype)[6:]
        for T in WKV_TS:
            inputs = wkv_inputs(gen, dev, dtype, T)
            check_wkv(ops, f"wkv6_scan {tag} T={T} zero state", dtype, inputs, None)
            s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
            _, whole, whole_state = check_wkv(ops, f"wkv6_scan {tag} T={T} random state",
                                              dtype, inputs, s0)
            if T != 777:
                continue
            buf = s0.clone()
            parts = [ops.wkv6_scan(*(t[:, :, a:b] for t in inputs[:4]), inputs[4],
                                   init_state=buf, final_state=buf)[0]
                     for a, b in ((0, CHUNK_SPLIT), (CHUNK_SPLIT, T))]
            torch.cuda.synchronize()
            split = torch.cat(parts, dim=2)
            check_close(f"wkv6_scan {tag} 512 + 265 from the carried state vs 777 out",
                        split, whole, str(dtype), WKV_TOL)
            check_close(f"wkv6_scan {tag} 512 + 265 vs 777 final state", buf, whole_state,
                        "torch.float32", WKV_TOL)
            log(f"    split bit-identical to whole: out {bool(torch.equal(split, whole))}, "
                f"state {bool(torch.equal(buf, whole_state))}")
        for regime, (mean, std) in WKV_DECAYS.items():
            inputs = wkv_inputs(gen, dev, dtype, 777, w_mean=mean, w_std=std)
            name = f"wkv6_scan {tag} T=777 {regime} decay, w ~ N({mean}, {std}),"
            check_wkv(ops, f"{name} zero state", dtype, inputs, None)
            s0 = torch.randn((WKV_HEADS, WKV_N, WKV_N), generator=gen, device=dev)
            check_wkv(ops, f"{name} random state", dtype, inputs, s0)
        r, k, v, w, u = wkv_inputs(gen, dev, dtype, 777)
        flat = [t.reshape(WKV_HEADS, 777, WKV_N) for t in (r, k, v, w)]  # (BH, T, N) copies
        check_wkv(ops, f"wkv6_scan {tag} (BH, T, N) contiguous, u (BH, N)", dtype,
                  (*flat, u.contiguous()), None)
    r, k, v, w, u = wkv_inputs(gen, dev, torch.bfloat16, 777, w_dtype=torch.float32)
    check_wkv(ops, "wkv6_scan bf16 with float32 w", torch.bfloat16, (r, k, v, w, u), None)


def measure_wkv(ops, dev, seed, T, launches, by_variant):
    """K5 at a median prompt of the serving run, bf16, as the path calls it
    (strided views, state updated in place in one buffer), checked and timed
    beside its plain version; its first, sequential kernel too (checked,
    then timed as ``prior_ms``), launched explicitly on the same inputs."""
    import torch

    from repro_torch.kernels import wkv6_scan as wk

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 10)
    inputs = wkv_inputs(gen, dev, torch.bfloat16, T)
    state = torch.zeros((WKV_HEADS, WKV_N, WKV_N), device=dev)
    name = f"wkv6_scan bf16 at a median prompt, T={T}"
    err, _, _ = check_wkv(ops, name, torch.bfloat16, inputs, state)
    check_wkv(ops, name, torch.bfloat16, inputs, state, kernel="sequential")
    nbytes, flops = wkv_work(T, torch.bfloat16)
    bound_ms, bound_by = bound(nbytes, flops, "torch.float32")
    row = {
        "variant": wk.variant(torch.bfloat16, T),
        "shape": f"median prompt: {WKV_HEADS} heads, T={T}, bf16",
        "launches_by_variant": by_variant,
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.wkv6_scan(*inputs, init_state=state, final_state=state), 20),
        "prior_ms": time_ms(lambda: wk.wkv6_scan(*inputs, init_state=state, final_state=state,
                                                 kernel="sequential"), 20),
        "plain_ms": time_ms(lambda: ops.wkv6_scan_plain(*inputs, init_state=state,
                                                        final_state=state), 3, 1),
        "library_ms": None,  # no single PyTorch call computes the WKV6 recurrence
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"    ms={row['ms']:.4f} prior_ms={row['prior_ms']:.4f} (sequential, "
        f"{row['prior_ms'] / row['ms']:.2f}x) plain_ms={row['plain_ms']:.4f} library: none (no "
        f"PyTorch call computes WKV6) bound_ms={bound_ms:.4f} ({bound_by}; bytes "
        f"{nbytes / PEAK_BYTES_PER_S * 1e3:.4f}, operations "
        f"{flops / PEAK_FLOPS['torch.float32'] * 1e3:.4f}) kernel/bound={row['ms'] / bound_ms:.1f}")
    return {"name": "wkv6_scan", "route": "cuda", "source": "src/repro_torch/kernels/csrc/wkv6_scan.cu",
            "replaces": REPLACES["wkv6_scan"], "launches": launches, **row}


def stage_logits(model, params, tokens, decode_tokens, keep=None):
    """Logits of a whole prefill, a chunked one (CHUNK_SPLIT + the rest) and
    decode steps fed ``decode_tokens`` after the whole prefill; and, where
    ``keep`` names a cache, copies of its tensors after the whole prefill."""
    import torch

    out = {}
    logits, caches = model.forward_prefill(params, tokens, CACHE_LEN)
    out["prefill"] = logits
    kept = None if keep is None else [c.clone() for c in caches[keep]]
    _, cc = model.forward_prefill(params, tokens[:, :CHUNK_SPLIT], CACHE_LEN)
    out["chunked"], _ = model.forward_prefill(params, tokens[:, CHUNK_SPLIT:], CACHE_LEN,
                                              caches=cc, start=CHUNK_SPLIT)
    del cc
    lengths = torch.tensor([tokens.shape[1]], device=tokens.device)
    for step, tok in enumerate(decode_tokens):
        out[f"decode step {step}"], caches = model.forward_decode(params, tok, caches, lengths)
        lengths = lengths + 1
    return out, kept


def phase_rwkv_model(ops, dev, seed):
    """(b) rwkv6-1.6b at full width: kernel path against plain path on the
    same seeded weights (data-dependent decay), in float32 and in bf16
    (``model_vs_plain_f32_bf16``).

    In float32 the two paths differ by float32 rounding alone, and the
    kernel path must be within MODEL_RTOL of the plain path (a wrong scan
    moves logits by O(1) of the largest). In bf16 a flipped rounding of
    one scan output grows through 24 layers and 777 tokens of recurrent
    state: two bf16 runs whose scans differ only in the order of float32
    sums end several percent apart. So in bf16 both paths are held against
    the float32 plain path (``hold_bf16``)."""
    from repro_torch.config import get_config

    def state_gap(a, b):
        return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))

    kept = model_vs_plain_f32_bf16(ops, get_config(RWKV), dev, seed, init=live_decay_,
                                   keep="wkv",
                                   note=f"w_lora_b ~ {LORA_B_SCALE} N(0, 1)")
    log(f"  wkv state after the whole prefill, max over layers of max |d| / max |S|, kernel vs "
        f"plain: f32 {state_gap(kept['f32', False], kept['f32', True]):.3e}, bf16 "
        f"{state_gap(kept['bf16', False], kept['bf16', True]):.3e}")


def hold_bf16(what, kernel, plain, ref32):
    """bf16 kernel-path logits against the float32 plain path's: no farther
    from them than twice the bf16 plain path is (plus 0.1% of the largest
    |logit|, so float32-level agreement always passes); the bf16 paths'
    distance from each other is printed beside it."""
    ref = ref32.float()
    scale = float(ref.abs().max())
    e_k = float((kernel.float() - ref).abs().max())
    e_p = float((plain.float() - ref).abs().max())
    e_kp = float((kernel.float() - plain.float()).abs().max())
    agree = bool((kernel.argmax(-1) == plain.argmax(-1)).all())
    ok = e_k <= 2 * e_p + 1e-3 * scale
    log(f"  bf16 {what}: kernel vs plain max_abs_err={e_kp:.4f} ({e_kp / scale:.2%} of max "
        f"|logit|) argmax_agree={agree}; vs the f32 plain path: kernel {e_k:.4f}, plain "
        f"{e_p:.4f} (kernel <= 2 x plain: {'ok' if ok else 'FAIL'})")
    if not ok:
        raise PhaseFailed(f"model bf16 {what}: the kernel path is farther from float32 than "
                          "twice the plain path")


def model_vs_plain_f32_bf16(ops, cfg, dev, seed, init=None, keep=None, note=""):
    """``cfg`` at full width on seeded random weights (``init(params, gen)``
    runs on them if given), the kernel path against the plain path over a
    whole prefill of PROMPT_LEN tokens, a chunked one (CHUNK_SPLIT + the
    rest) and DECODE_STEPS decode steps, in float32 (within MODEL_RTOL) and
    in bf16 (``hold_bf16``: each path against the float32 plain path; a
    bf16 rounding can flip a top-8-of-32 routing or grow through a
    recurrent state). The chunked prefill is held against the plain path's
    whole prefill, except for an MoE config, whose capacity is per chunk,
    where it is held against the plain path's chunked one. Fails unless
    each kernel run launched K4 once per attention layer per prefill or
    chunk and K3 once per attention layer per decode step, by the
    wrapper's rule at each dtype. Returns the ``keep`` cache's tensors
    after the whole prefill, by (dtype, plain)."""
    import dataclasses

    import torch

    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import build_model
    from repro_torch.tree import tree_map

    t0 = time.perf_counter()
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = build_model(cfg, device=dev).init(gen)
    if init is not None:
        init(params, gen)
    n_attn = attention_layers(cfg)
    log(f"  {cfg.name} {cfg.dtype}: {tree_params(params) / 1e9:.3f}B params in the tree "
        f"({cfg.param_count() / 1e9:.3f}B by cfg.param_count()), {cfg.num_layers} layers, "
        f"{n_attn} with attention, d_model {cfg.d_model}{'; ' + note if note else ''}; "
        "float32 copy of the same weights")
    rng = np.random.RandomState(seed)
    tokens = torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(1, PROMPT_LEN)), device=dev)
    decode_tokens = [torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(1,)), device=dev)
                     for _ in range(DECODE_STEPS)]
    runs, kept = {}, {}
    ops.reset_counters()
    with torch.no_grad():
        for name, c in (("bf16", cfg), ("f32", cfg32)):
            p = params if name == "bf16" else tree_map(lambda t: t.float(), params)
            for plain in (False, True):
                model = build_model(c, device=dev, plain_kernels=plain)
                runs[name, plain], kept[name, plain] = stage_logits(model, p, tokens,
                                                                    decode_tokens, keep)
            del p
            torch.cuda.empty_cache()
    torch.cuda.synchronize()
    del params
    torch.cuda.empty_cache()
    for op, kernel, per_run in (("flash_attention", fa, 3 * n_attn),
                                ("decode_attention", da, DECODE_STEPS * n_attn)):
        want = {}
        for dtype in (torch.bfloat16, torch.float32):
            if per_run:
                v = kernel.variant(dtype, cfg.head_dim)
                want[v] = want.get(v, 0) + per_run
        got = dict(ops.COUNTERS[op].variants)
        log(f"    {op} launches over both kernel runs: {got}")
        if got != want:
            raise PhaseFailed(f"{cfg.name}: {op} launches {got}, not {want}")
    k32, p32 = runs["f32", False], runs["f32", True]
    kbf, pbf = runs["bf16", False], runs["bf16", True]
    whole = cfg.moe is None
    for stage in k32:
        want = "prefill" if stage == "chunked" and whole else stage
        what = (f"{cfg.name} chunked prefill {CHUNK_SPLIT} + {PROMPT_LEN - CHUNK_SPLIT}"
                + (" vs whole" if whole else "")
                if stage == "chunked" else f"{cfg.name} {stage} ({PROMPT_LEN}-token prompt)")
        compare_logits(f"f32 {what}", k32[stage], p32[want])
        hold_bf16(what, kbf[stage], pbf[want], p32[want])
    log(f"    {time.perf_counter() - t0:.1f} s")
    return kept


def phase_rwkv(ops, dev, seed, profile=False):
    """Phase 5: (a) K5, (b) the full-width model, (c) four rwkv6-1.6b
    tenants served in both modes; returns K5's kernels row."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import build_model

    log(" (a) K5 wkv6_scan against its plain version")
    phase_wkv_kernel(ops, dev, seed)
    log(f" (b) {RWKV} at full width, kernel path vs plain path")
    phase_rwkv_model(ops, dev, seed)
    torch.cuda.empty_cache()
    log(f" (c) serving {REQUESTS} requests for {R_TENANTS} {RWKV} tenants")
    cfg = get_config(RWKV)
    model = build_model(cfg, device=dev)
    stacked = stacked_tenants(model, dev, seed, live_decay_)
    prompts, lens = serve_prompts(cfg, seed)
    launches, per_mode, _ = serve_both_modes(model, stacked, prompts, ops, ("wkv6_scan",))
    by_variant = dict(ops.COUNTERS["wkv6_scan"].variants)
    want = cfg.num_layers * REQUESTS  # one launch per layer per (unchunked) prefill
    for mode, per in zip(("space_time", "time_only"), per_mode):
        if per["wkv6_scan"] != want:
            raise PhaseFailed(f"{mode}: wkv6_scan launched {per['wkv6_scan']} times, "
                              f"not {cfg.num_layers} per prefill ({want})")
    log(f"  wkv6_scan launches per mode: {want} = {cfg.num_layers} layers x {REQUESTS} prefills; "
        f"by variant on the serving path: {by_variant}")
    if by_variant.get("chunked", 0) != launches["wkv6_scan"]:
        raise PhaseFailed(f"wkv6_scan: {launches['wkv6_scan']} launches on the serving path, not "
                          f"all chunked: {by_variant}")
    if profile:
        profile_serving(model, stacked, prompts)
        profile_prefill(model, stacked, prompts)
    del stacked
    torch.cuda.empty_cache()
    log("kernels at the RWKV serving path's shapes")
    return [measure_wkv(ops, dev, seed, int(np.median(lens)), launches["wkv6_scan"], by_variant)]


def profile_prefill(model, stacked, prompts):
    """K5's share of a prefill: torch.profiler over one tenant's prefill of
    the median prompt (after two unprofiled ones). Prints the host wall
    time, the device time in kernels, K5's device time and launches, and
    K5's share of the kernel time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.tenancy import tenant_view

    t, prompt = sorted(prompts, key=lambda p: len(p[1]))[len(prompts) // 2]
    params = tenant_view(stacked, t)
    tokens = torch.as_tensor(np.asarray(prompt, np.int64), device=model.device)[None, :]
    with torch.no_grad():
        for _ in range(2):
            model.forward_prefill(params, tokens, CACHE_LEN)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.forward_prefill(params, tokens, CACHE_LEN)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = sum(e.self_device_time_total for e in kernels)
    k5 = [e for e in kernels if "wkv6_" in e.key]
    k5_us = sum(e.self_device_time_total for e in k5)
    log(f"  profile prefill of {tokens.shape[1]} tokens (tenant {t}): wall {wall * 1e3:.3f} ms, "
        f"kernels {busy_us / 1e3:.3f} ms, K5 {k5_us / 1e3:.3f} ms in "
        f"{sum(e.count for e in k5)} launches, K5 share of kernel time "
        f"{k5_us / max(busy_us, 1e-9):.3f}, of wall {k5_us / 1e6 / wall:.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]:
        log(f"    {e.self_device_time_total / 1e3:8.3f} ms {e.count:5d}x  {e.key[:90]}")


# ----------------------------------------------------------------- phase 6
# paligemma-3b at full width: head dim 256, one kv head for 8
# query heads, its stub SigLIP frontend fed 256 seeded patch embeddings;
# then musicgen-large, qwen2-7b, granite-3-8b and gemma3-27b.
PALI = "paligemma-3b"
# (arch, layers kept, prompt tokens): full width, depth cut so the whole run
# stays in time. gemma3 keeps 6 layers, so its sixth (global) layer runs
# beside five sliding-window ones, and a prompt past its 1024-key window, so
# K4 masks by the window and the ring caches wrap.
OTHER_CONFIGS = (("musicgen-large", 2, PROMPT_LEN), ("qwen2-7b", 2, PROMPT_LEN),
                  ("granite-3-8b", 2, PROMPT_LEN), ("gemma3-27b", 6, 1300))
OTHER_DECODE_STEPS = 4


def phase_pali(ops, dev, seed, profile=False):
    """Phase 6: (a) paligemma-3b's kernel path against its plain path over
    a prefill of 256 prefix embeddings + 521 tokens and 8 decode steps; (b)
    four tenants served in both modes (K4 wgmma at D = 256 once per layer
    per prefill, K3 split_kv), with its kernels rows; (c) musicgen-large,
    qwen2-7b, granite-3-8b and gemma3-27b, kernel path against plain path
    over a prefill and 4 decode steps. Returns the kernels rows."""
    import dataclasses

    import torch

    from repro_torch.config import get_config

    cfg = get_config(PALI)
    if cfg.head_dim != 256:
        raise PhaseFailed(f"{PALI}: head dim {cfg.head_dim}, not 256")
    log(f" (a) {PALI} at full width, kernel path vs plain path")
    model_vs_plain(ops, cfg, dev, seed, PROMPT_LEN, DECODE_STEPS)
    log(f" (b) serving {REQUESTS} requests for {R_TENANTS} {PALI} tenants (text only, as the "
        "reference's engine)")
    cfg, launches, per_mode, lens = phase_serving(dev, seed, ops, PALI, profile)
    torch.cuda.empty_cache()
    log(f"kernels at {PALI}'s serving path's shapes")
    rows = main_path_kernel_rows(ops, dev, seed, cfg, lens, launches, per_mode)
    log(f" (c) {', '.join(a for a, _, _ in OTHER_CONFIGS)} at full width, cut in depth")
    for arch, layers, n in OTHER_CONFIGS:
        full = get_config(arch)
        log(f"  {arch}: {layers} of {full.num_layers} layers")
        model_vs_plain(ops, dataclasses.replace(full, num_layers=layers), dev, seed, n,
                       OTHER_DECODE_STEPS)
    return rows


# ----------------------------------------------------------------- phase 7
# The last three architectures: granite-moe-1b-a400m (attention + MoE in
# every layer, top-8 of 32 experts), zamba2-7b (68 Mamba2 layers and one
# shared attention block of head dim 112 applied at 13 positions) and
# llama4-maverick (a dense and an MoE layer in turn, 128 experts and a
# shared expert).
MOE_ARCH = "granite-moe-1b-a400m"
ZAMBA = "zamba2-7b"
LLAMA4 = "llama4-maverick-400b-a17b"
LLAMA4_LAYERS = 2  # one period of its pattern: a dense layer, then an MoE layer


def phase_new_archs(ops, dev, seed, profile=False):
    """Phase 7: (a) granite-moe-1b-a400m and zamba2-7b at full width,
    kernel path against plain path in float32 and bf16, then
    llama4-maverick at full width and LLAMA4_LAYERS layers in bf16; (b)
    four tenants of granite-moe and of zamba2 served in both modes (K4 by
    the wrapper's rule once per attention layer per prefill, K3 split_kv
    once per attention layer per decode pass), with their kernels rows.
    Returns the rows."""
    import dataclasses

    import torch

    from repro_torch.config import get_config
    from repro_torch.kernels import flash_attention as fa

    log(f" (a) {MOE_ARCH} and {ZAMBA} at full width, kernel path vs plain path, f32 and bf16")
    for arch in (MOE_ARCH, ZAMBA):
        model_vs_plain_f32_bf16(ops, get_config(arch), dev, seed)
    full = get_config(LLAMA4)
    log(f"  {LLAMA4}: {LLAMA4_LAYERS} of {full.num_layers} layers at full width (a dense layer, "
        f"then an MoE layer of all {full.moe.num_experts} experts and the shared expert), bf16")
    cut = dataclasses.replace(full, num_layers=LLAMA4_LAYERS,
                              block_pattern=full.block_pattern[:LLAMA4_LAYERS])
    model_vs_plain(ops, cut, dev, seed, PROMPT_LEN, OTHER_DECODE_STEPS)
    torch.cuda.empty_cache()
    rows = []
    for arch in (MOE_ARCH, ZAMBA):
        log(f" (b) serving {REQUESTS} requests for {R_TENANTS} {arch} tenants")
        cfg = get_config(arch)
        cfg, launches, per_mode, lens = phase_serving(
            dev, seed, ops, arch, profile, flash_variant=fa.variant(torch.bfloat16, cfg.head_dim))
        torch.cuda.empty_cache()
        log(f"kernels at {arch}'s serving path's shapes")
        rows += main_path_kernel_rows(ops, dev, seed, cfg, lens, launches, per_mode)
    return rows


# ----------------------------------------------------------------- main
@contextlib.contextmanager
def phase_wall(n):
    t = time.perf_counter()
    yield
    log(f"phase {n}: {time.perf_counter() - t:.1f} s wall")


def build_report(_build):
    """ptxas's report for every kernel instance (entry function, registers,
    spills; static shared memory is on the registers line), the dynamic
    shared memory of the wgmma kernels (K4 at D = 64, 128, 256), K3's
    split_kv ring at every head dim in both dtypes (held equal to the
    wrapper's ``ring_bytes``) and K5's chunked kernel, and how many of K3's
    clusters fit on the card at once at stablelm's and paligemma's decode
    shapes."""
    import ctypes

    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if any(key in line for key in ("entry function", "registers", "spill")):
                log(f"  ptxas {name}: {line.strip().removeprefix('ptxas info    : ')}")
    gg = _build.load("grouped_gemm").repro_grouped_gemm_smem
    fa = _build.load("flash_attention").repro_flash_attention_smem
    bg = _build.load("batched_gemm").repro_batched_gemm_smem
    da = _build.load("decode_attention")
    wk = _build.load("wkv6_scan").repro_wkv6_scan_smem
    gg.argtypes, gg.restype = [], ctypes.c_int
    for fn, n in ((fa, 1), (bg, 1), (da.repro_decode_attention_smem, 2),
                  (da.repro_decode_attention_clusters, 4), (wk, 2)):
        fn.argtypes, fn.restype = [ctypes.c_int] * n, ctypes.c_int
    log(f"  dynamic shared memory: grouped_gemm wgmma {gg()} bytes; batched_gemm wgmma 64-row "
        f"{bg(64)}, 128-row {bg(128)} bytes; flash_attention wgmma "
        + ", ".join(f"D={d} {fa(d)}" for d in (64, 128, 256))
        + " bytes; decode_attention split_kv ring "
        + ", ".join(f"D={d} {t} {da.repro_decode_attention_smem(d, c)}"
                    for d in (64, 112, 128, 256) for t, c in (("f32", 0), ("bf16", 1)))
        + f" bytes; wkv6_scan chunked f32 {wk(0, 1)}, bf16 {wk(1, 0)} bytes")
    import torch

    from repro_torch.kernels import decode_attention as dapy

    for d in (64, 112, 128, 256):  # the wrapper's mirror of the ring agrees with the source
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            if da.repro_decode_attention_smem(d, code) != dapy.ring_bytes(dtype, d):
                raise PhaseFailed(f"decode_attention: ring of D={d} {dtype} is "
                                  f"{da.repro_decode_attention_smem(d, code)} bytes, the wrapper "
                                  f"says {dapy.ring_bytes(dtype, d)}")
    if fa(256) <= 0:
        raise PhaseFailed("flash_attention: no wgmma kernel at D=256")
    for d, g in ((64, 1), (256, 8)):  # stablelm's and paligemma's decode steps
        clusters = da.repro_decode_attention_clusters(d, 1, g, 4)
        log(f"  decode_attention split_kv clusters of 4 resident at once (D={d} bf16, "
            f"q_per_kv {g}): {clusters}")
        if clusters <= 0:
            raise PhaseFailed("decode_attention: no cluster of the split_kv kernel fits on the "
                              "card")


def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3,4,5,6,7", help="comma list of phases to run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after phases 3, 5, 6 and 7, profile steady decode steps of both "
                         "modes; after phase 4, profile the scheduler's two GEMM streams")
    ap.add_argument("--rows-out", metavar="FILE",
                    help="write the kernels rows to FILE as JSON, in place of the closing "
                         "lines (how phase 4 reports to the run that started it)")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}
    # Phase 4's space_only spreads its products over 32 streams (Hyper-Q),
    # which map onto 32 hardware queues only with this setting (CUDA's
    # default is 8), read when the CUDA context is made. Phases 1-3 keep
    # CUDA's default: run alone, phase 4 sets it here, before torch touches
    # the card; after other phases, it runs in a process of its own.
    gemm_apart = 4 in phases and len(phases) > 1
    if phases == {4}:
        os.environ.setdefault("CUDA_DEVICE_MAX_CONNECTIONS", GEMM_MAX_CONNECTIONS)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing run", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    secs = _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s wall "
        + " ".join(f"{k}={v:.1f}s" for k, v in secs.items()))
    rows = []
    try:
        if not args.rows_out:  # a child run of phase 4 reuses the parent's build and report
            build_report(_build)
        if 1 in phases:
            log("phase 1: kernels against their plain versions on the card")
            with phase_wall(1):
                phase_kernels(ops, dev, args.seed)
        if 2 in phases:
            log("phase 2: stablelm-1.6b at full width, kernel path vs plain path")
            with phase_wall(2):
                phase_model(ops, dev, args.seed)
        if 3 in phases:
            log(f"phase 3: serving {REQUESTS} requests for {R_TENANTS} stablelm-1.6b tenants")
            with phase_wall(3):
                cfg, launches, per_mode, prompt_lens = phase_serving(
                    dev, args.seed, ops, "stablelm-1.6b", args.profile)
                log("kernels at the serving path's shapes")
                rows += main_path_kernel_rows(ops, dev, args.seed, cfg, prompt_lens, launches,
                                              per_mode)
        if gemm_apart:
            torch.cuda.empty_cache()
            with phase_wall(4):
                rows += phase_gemm_apart(args.seed, args.profile)
        elif 4 in phases:
            log("phase 4: the GEMM super-kernel path (K1, K2, Table 1, the scheduler)")
            with phase_wall(4):
                rows += phase_gemm(ops, dev, args.seed, args.profile)
        if 5 in phases:
            torch.cuda.empty_cache()
            log(f"phase 5: the RWKV-6 serving path ({RWKV}, K5)")
            with phase_wall(5):
                rows += phase_rwkv(ops, dev, args.seed, args.profile)
        if 6 in phases:
            torch.cuda.empty_cache()
            log(f"phase 6: {PALI} at full width (K3, K4 at D=256), then musicgen-large, "
                "qwen2-7b, granite-3-8b and gemma3-27b")
            with phase_wall(6):
                rows += phase_pali(ops, dev, args.seed, args.profile)
        if 7 in phases:
            torch.cuda.empty_cache()
            log(f"phase 7: {MOE_ARCH} and {ZAMBA} served at full width, {LLAMA4} at "
                f"{LLAMA4_LAYERS} layers")
            with phase_wall(7):
                rows += phase_new_archs(ops, dev, args.seed, args.profile)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if args.rows_out:
        Path(args.rows_out).write_text(json.dumps(rows))
        return 0
    if rows:
        log(json.dumps({"kernels": rows}))
    log(gpu_identity())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
