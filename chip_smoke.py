#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one H100.

    python3 chip_smoke.py                 # every phase, as a check run does
    python3 chip_smoke.py --phases 1      # kernels against plain versions only
    python3 chip_smoke.py --phases 3 --profile   # + where a decode step's time goes

Builds the CUDA kernels from ``src/repro_torch/kernels/csrc`` (into
``build/repro_torch/``), then:

  1. holds every kernel against its plain PyTorch version on the card, in
     float32 and bfloat16, at the shapes of the serving path, and times the
     kernel, the plain version and ``scaled_dot_product_attention`` (the
     library yardstick, which the port never calls);
  2. builds stablelm-1.6b at full width (bf16, seeded random weights) and
     compares the kernel path's logits with the plain path's over a
     777-token prefill and 8 decode steps;
  3. serves 16 requests for four full-width stablelm-1.6b tenants through
     ``MultiTenantEngine`` in ``space_time`` and ``time_only`` mode, with
     every kernel's launch counter read around the run.

Prints a ``kernels`` JSON line, the card's name and power limit, and, last,
``{"ok": true, "device": {...}}``. Exits non-zero, printing no result, if
there is no CUDA card, if the port cannot be imported, or if any phase fails.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
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
}


class PhaseFailed(Exception):
    pass


def log(*args) -> None:
    print(*args, flush=True)


def time_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls, by CUDA events."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(name: str, got, want, dtype_key: str) -> float:
    import torch

    rtol, atol = TOL[dtype_key]
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
def measure_flash(ops, dev, gen, dtype, B, Hq, Hkv, Sq, Skv, D, window, q_offset=None,
                  iters=20):
    import torch

    q = torch.randn((B, Hq, Sq, D), generator=gen, device=dev).to(dtype)
    k = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    v = torch.randn((B, Hkv, Skv, D), generator=gen, device=dev).to(dtype)
    qo = Skv - Sq if q_offset is None else q_offset
    kw = dict(causal=True, window=window, q_offset=qo)
    got = ops.flash_attention(q, k, v, **kw)
    want = ops.flash_attention_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    name = f"flash_attention {str(dtype)[6:]} {(B, Hq, Hkv, Sq, Skv, D)} window={window} q_offset={qo}"
    err = check_close(name, got, want, str(dtype))
    nbytes, flops = flash_work(B, Hq, Hkv, Sq, Skv, D, True, window, qo, str(dtype))
    bound_ms, bound_by = bound(nbytes, flops, str(dtype))
    row = {
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.flash_attention(q, k, v, **kw), iters),
        "plain_ms": time_ms(lambda: ops.flash_attention_plain(q, k, v, **kw), 3, 1),
        "library_ms": time_ms(sdpa_flash(q, k, v, True, window, qo), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} sdpa_ms={row['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return row


def measure_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths, iters=20):
    import torch

    q = torch.randn((B, Hq, D), generator=gen, device=dev).to(dtype)
    kc = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    vc = torch.randn((B, Hkv, S, D), generator=gen, device=dev).to(dtype)
    lens = torch.as_tensor(np.asarray(lengths, np.int32), device=dev)
    got = ops.decode_attention(q, kc, vc, lens)
    want = ops.decode_attention_plain(q, kc, vc, lens)
    torch.cuda.synchronize()
    name = (f"decode_attention {str(dtype)[6:]} {(B, Hq, Hkv, S, D)} "
            f"lengths min={min(lengths)} max={max(lengths)}")
    err = check_close(name, got, want, str(dtype))
    nbytes, flops = decode_work(B, Hq, Hkv, S, D, lengths, str(dtype))
    bound_ms, bound_by = bound(nbytes, flops, str(dtype))
    row = {
        "max_abs_err": err,
        "ms": time_ms(lambda: ops.decode_attention(q, kc, vc, lens), iters),
        "plain_ms": time_ms(lambda: ops.decode_attention_plain(q, kc, vc, lens), 3, 1),
        "library_ms": time_ms(sdpa_decode(q, kc, vc, lens), iters),
        "bound_ms": bound_ms, "bound_by": bound_by,
    }
    log(f"    ms={row['ms']:.4f} plain_ms={row['plain_ms']:.4f} sdpa_ms={row['library_ms']:.4f} "
        f"bound_ms={bound_ms:.4f} ({bound_by})")
    return row


def phase_kernels(ops, dev, seed):
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    rng = np.random.RandomState(seed)
    for dtype in (torch.float32, torch.bfloat16):
        for S in (777, 1024):
            for window in (0, 512):
                measure_flash(ops, dev, gen, dtype, 1, 32, 32, S, S, 64, window)
        measure_flash(ops, dev, gen, dtype, 1, 28, 4, 777, 777, 128, 0)
        measure_flash(ops, dev, gen, dtype, 1, 32, 32, 64, 1024, 64, 0)           # suffix
        measure_flash(ops, dev, gen, dtype, 1, 32, 32, 64, 1024, 64, 0, q_offset=512)  # chunk
        for (B, Hq, Hkv, S, D) in ((16, 32, 32, 2048, 64), (16, 28, 4, 2048, 128)):
            lengths = [1, 2048] + list(rng.randint(1, 2049, size=B - 2))
            measure_decode(ops, dev, gen, dtype, B, Hq, Hkv, S, D, lengths)
        # the other GQA ratios the kernels take (q_per_kv 2, 4, 8), both head
        # dims, a ragged sequence length and a length-0 decode row
        for g in (2, 4, 8):
            for D in (64, 128):
                measure_flash(ops, dev, gen, dtype, 2, 4 * g, 4, 300, 300, D, 64, iters=3)
                measure_decode(ops, dev, gen, dtype, 4, 4 * g, 4, 600, D, [0, 1, 333, 600],
                               iters=3)


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


def phase_model(dev, seed):
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import build_model
    from repro_torch.tree import tree_leaves

    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg, device=dev)
    plain = build_model(cfg, device=dev, plain_attention=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    nparams = sum(t.numel() for t in tree_leaves(params))
    log(f"  stablelm-1.6b {cfg.dtype}: {nparams / 1e9:.3f}B params, "
        f"{cfg.num_layers} layers, d_model {cfg.d_model}")
    rng = np.random.RandomState(seed)
    tokens = torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(1, PROMPT_LEN)), device=dev)

    def compare(what, got, want):
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

    with torch.no_grad():
        lk, ck = model.forward_prefill(params, tokens, CACHE_LEN)
        lp, cp = plain.forward_prefill(params, tokens, CACHE_LEN)
        compare(f"prefill {PROMPT_LEN} tokens", lk, lp)
        lengths = torch.tensor([PROMPT_LEN], device=dev)
        for step in range(DECODE_STEPS):
            tok = lk.argmax(-1)  # both paths decode the same token
            lk, ck = model.forward_decode(params, tok, ck, lengths)
            lp, cp = plain.forward_decode(params, tok, cp, lengths)
            compare(f"decode step {step}", lk, lp)
            lengths = lengths + 1
    torch.cuda.synchronize()


# ----------------------------------------------------------------- phase 3
R_TENANTS = 4
SLOTS = 4
REQUESTS = 16
MAX_NEW = 32


def run_engine(model, stacked, mode, prompts, ops):
    import torch

    from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine

    eng = MultiTenantEngine(model, stacked_params=stacked, config=EngineConfig(
        num_tenants=R_TENANTS, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, mode=mode))
    reqs = [InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=MAX_NEW) for t, p in prompts]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = {k: c.launches for k, c in ops.COUNTERS.items()}
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
        + f" (decode_attention per decode step = {launches['decode_attention'] / max(1, eng.steps):.1f})")
    if len(eng.finished) != REQUESTS or len(done) != REQUESTS:
        raise PhaseFailed(f"{mode}: not every request finished with {MAX_NEW} tokens")
    for k, n in launches.items():
        if n <= 0:
            raise PhaseFailed(f"{mode}: kernel {k} was never launched on the serving path")
    tokens = {r.request_id: list(r.generated) for r in reqs}
    del eng
    return tokens, reqs


def phase_serving(dev, seed, ops, profile=False):
    import torch

    from repro_torch.config import get_config
    from repro_torch.core.tenancy import tenant_bytes
    from repro_torch.models import build_model

    cfg = get_config("stablelm-1.6b")
    model = build_model(cfg, device=dev)
    gens = []
    for t in range(R_TENANTS):
        g = torch.Generator(device=dev)
        g.manual_seed(seed + 1 + t)
        gens.append(g)
    stacked = model.init_stacked(gens)
    wbytes = tenant_bytes(stacked)
    log(f"  {R_TENANTS} tenants stacked: {wbytes / 1e9:.2f} GB of bf16 weights; merged decode "
        f"step weight-bytes bound {wbytes / PEAK_BYTES_PER_S * 1e3:.3f} ms at 3.35 TB/s")
    rng = np.random.RandomState(seed)
    lens = rng.randint(128, 1025, size=REQUESTS)
    prompts = [(i % R_TENANTS, rng.randint(1, cfg.vocab_size, size=int(n)).tolist())
               for i, n in enumerate(lens)]
    log(f"  prompts: lengths {sorted(int(x) for x in lens)}")

    ops.reset_counters()  # the main path starts here
    tok_st, reqs_st = run_engine(model, stacked, "space_time", prompts, ops)
    torch.cuda.empty_cache()
    tok_to, reqs_to = run_engine(model, stacked, "time_only", prompts, ops)
    launches = {k: c.launches for k, c in ops.COUNTERS.items()}
    plain_calls = {k: c.plain_calls for k, c in ops.COUNTERS.items()}
    if any(plain_calls.values()):
        raise PhaseFailed(f"plain versions were called on the serving path: {plain_calls}")
    same = sum(a == b for r1, r2 in zip(reqs_st, reqs_to)
               for a, b in zip(tok_st[r1.request_id], tok_to[r2.request_id]))
    log(f"  greedy-token agreement space_time vs time_only: {same}/{REQUESTS * MAX_NEW} "
        "(bf16: exact agreement not required)")
    log(f"  main-path launches (both modes): {launches}; plain-version calls: {plain_calls}")
    if profile:
        profile_serving(model, stacked, prompts)
    return launches, [int(x) for x in lens]


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


def main_path_kernel_rows(ops, dev, seed, prompt_lens, launches):
    """Kernel vs plain vs SDPA at the serving path's own shapes (bf16)."""
    import torch

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed + 100)
    lens_mid = [n + MAX_NEW // 2 for n in prompt_lens]  # mid-generation cache lengths
    n_heads, head_dim = 32, 64
    log(f"  decode_attention at the merged decode step: R*B={R_TENANTS * SLOTS}, "
        f"cache {CACHE_LEN}, lengths = prompt + {MAX_NEW // 2}")
    dec = measure_decode(ops, dev, gen, torch.bfloat16, R_TENANTS * SLOTS, n_heads, n_heads,
                         CACHE_LEN, head_dim, lens_mid)
    s_med = int(np.median(prompt_lens))
    log(f"  flash_attention at a median prefill: {s_med} tokens")
    fl = measure_flash(ops, dev, gen, torch.bfloat16, 1, n_heads, n_heads, s_med, s_med,
                       head_dim, 0)
    rows = []
    for name, row in (("decode_attention", dec), ("flash_attention", fl)):
        rows.append({"name": name, "route": "cuda",
                     "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                     "replaces": REPLACES[name], "launches": launches[name], **row})
    return rows


# ----------------------------------------------------------------- main
def gpu_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        raise PhaseFailed(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--phases", default="1,2,3", help="comma list of phases to run")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="after phase 3, profile steady decode steps of both modes")
    args = ap.parse_args(argv)
    phases = {int(p) for p in args.phases.split(",")}

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
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")
    rows = None
    try:
        if 1 in phases:
            log("phase 1: kernels against their plain versions on the card")
            phase_kernels(ops, dev, args.seed)
        if 2 in phases:
            log("phase 2: stablelm-1.6b at full width, kernel path vs plain path")
            phase_model(dev, args.seed)
        if 3 in phases:
            log(f"phase 3: serving {REQUESTS} requests for {R_TENANTS} stablelm-1.6b tenants")
            launches, prompt_lens = phase_serving(dev, args.seed, ops, args.profile)
            log("kernels at the serving path's shapes")
            rows = main_path_kernel_rows(ops, dev, args.seed, prompt_lens, launches)
    except PhaseFailed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    if rows is not None:
        log(json.dumps({"kernels": rows}))
    log(gpu_identity())
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                            "kind": torch.cuda.get_device_name(0),
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
