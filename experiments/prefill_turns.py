#!/usr/bin/env python3
"""Prefills and decode steps on the card, by route: wall, kernel time, launches, idle share.

    python3 experiments/prefill_turns.py                       # zamba2-7b, whole prompts
    python3 experiments/prefill_turns.py --root DIR --arch stablelm-1.6b,rwkv6-1.6b \\
        --routes whole,pieces,graphed
    python3 experiments/prefill_turns.py --root DIR --routes whole,graphed,decode
    python3 experiments/prefill_turns.py --root DIR --routes step
    python3 experiments/prefill_turns.py --root DIR --routes state

Builds each ``--arch`` at full width and depth (bf16, seeded random weights,
one tenant) from the port under ``DIR/src`` (default: the checkout this
script lies in), so that two checkouts can be compared in one call with one
copy of the script. It prefills the 16 prompts ``chip_smoke.py``'s serving
phases draw for seed 0 (128-1024 random tokens) into a cache of 2048
positions by each route of ``--routes``:

- ``whole``: one ``forward_prefill`` of the whole prompt into a fresh cache
  (the eager engine's route);
- ``pieces``: the same prompt as the engine's piece lengths (512, 128, ...
  for 742 tokens: descending powers of two below 2048), eagerly, the first
  piece fresh and each later one a continuation from a host-int ``start``
  (what a checkout without device starts can run);
- ``graphed``: an engine of one tenant on the graph route, which captures
  one program a piece size when it is built; each prefill replays them
  (``MultiTenantEngine._run_pieces``). Needs a checkout with the piece
  route; its build's capture seconds and pool bytes are reported.

- ``decode``: not a prefill. Four tenants (seeded weights) x 4 slots on
  the graph route serve the 16 prompts, once in ``space_time`` (the merged
  decode step) and once in ``time_only`` (each tenant's); after the step
  that prefills and the one that captures, ``--steps`` steady steps are
  timed on the host clock to a synchronize, and the step's graphs are
  replayed back to back ``--steps`` times under CUDA events (the step's
  device ms; idle share = 1 - device / wall), as ``chip_smoke.py``'s
  ``graphs`` line times them. One JSON line per mode.

- ``step``: not a prefill, and no model. ``ops.ssd_step`` (SSD-step, the
  Mamba2 decode mixer) alone at zamba2-7b's width, merged (R 4 tenants x
  B 4 slots) and one tenant's (R 1 x B 4), bf16 and float32, by this
  checkout's ``chip_smoke.ssd_step_times`` (the harness of its SSD-step
  rows): one step held against ``ops.ssd_step_plain``, then timed by CUDA
  events behind a sleep, ``ms`` cycling over caches past
  ``SSD_STEP_COLD_BYTES`` of state (each launch reads its state from
  device memory, as a decode pass does) and ``ms_warm`` on one cache
  (its state held in the 50 MB L2). Runs once, whatever ``--arch``; one
  JSON line per (dtype, R, B) with the launches by variant and the
  library's register report.

- ``state``: not a prefill, and no model. K5-state (``ops.wkv6_state``)
  and K5 (``ops.wkv6_scan``) alone at rwkv6-1.6b's 32 heads, at every
  piece size of the graphed prefill (``chip_smoke.state_pieces``, 1024
  down to 1 tokens), by this checkout's ``chip_smoke.piece_kernel_times``
  (the harness of phase 5's rows at those sizes): each checked against its
  plain version, then timed by CUDA events behind a sleep. Runs once,
  whatever ``--arch``; one JSON line per op and size with the variant its
  wrapper counted. ``--state-lengths`` times other lengths by the same
  harness (e.g. the median whole prompt 742 and phase 11's 32768, where
  K5-state takes its segmented kernel).

Each prefill route prefills two prompts unmeasured, then every prompt ``--repeats``
times, each prefill timed on the host clock around a synchronize. One
prefill of the median prompt runs under ``torch.profiler``: its wall, its
kernel time and kernel count (device activities), the idle share (1 -
kernel time / wall) and K4's (``flash_attention`` kernels) time and
launches. Prints one JSON line per (arch, route) with the card's name and
power limit. Needs a CUDA card; exits 2 without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REQUESTS = 16
CACHE_LEN = 2048


def pieces(S: int):
    """The piece route's lengths at cache 2048 with no chunk: S in
    descending powers of two below 2048 (1024s first)."""
    top = CACHE_LEN // 2
    rest = S % top
    return [top] * (S // top) + [1 << i for i in range(rest.bit_length() - 1, -1, -1)
                                 if rest >> i & 1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--arch", default="zamba2-7b", help="comma list")
    ap.add_argument("--routes", default="whole",
                    help="comma list of whole, pieces, graphed, decode, step, state")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--steps", type=int, default=8, help="steady decode steps (route decode)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--state-lengths", default=None,
                    help="comma list of lengths for route state (default: every piece size)")
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("prefill_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.kernels import _build

    routes = args.routes.split(",")
    # every kernel at once, one nvcc a source (only their own for the step and state routes)
    alone = {"step": ["ssd_step"], "state": ["wkv6_state", "wkv6_scan"]}
    _build.build(sorted({n for r in routes for n in alone[r]}) if set(routes) <= set(alone)
                 else _build.SOURCES)
    ident = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    for route, measure_alone in (("step", measure_step), ("state", measure_state)):
        if route in routes:
            routes.remove(route)
            for rec in measure_alone(args):
                rec["card"] = ident
                print(json.dumps({"prefill_turns": rec}), flush=True)
    for arch in args.arch.split(",") if routes else []:
        for route in routes:
            recs = ([measure_decode(arch, mode, args) for mode in ("space_time", "time_only")]
                    if route == "decode" else [measure(arch, route, args)])
            for rec in recs:
                rec["card"] = ident
                print(json.dumps({"prefill_turns": rec}), flush=True)
            torch.cuda.empty_cache()
    return 0


TENANTS = 4
SLOTS = 4
SLEEP_CYCLES = 20_000_000  # ~10 ms queued ahead of the timed replays


def measure_decode(arch: str, mode: str, args) -> dict:
    """The graphed decode step of TENANTS x SLOTS in ``mode``: host wall per
    steady step, the device ms of the step's graphs replayed back to back."""
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import build_model
    from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine

    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    gens = []
    for t in range(TENANTS):
        gen = torch.Generator(device=dev)
        gen.manual_seed(args.seed + 1 + t)
        gens.append(gen)
    stacked = model.init_stacked(gens)
    eng = MultiTenantEngine(model, stacked_params=stacked, graphs=True, config=EngineConfig(
        num_tenants=TENANTS, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, mode=mode))
    rng = np.random.RandomState(args.seed)
    lens = rng.randint(128, 1025, size=REQUESTS)
    for i, n in enumerate(lens):
        eng.submit(InferenceRequest(tenant_id=i % TENANTS, prompt=rng.randint(
            1, cfg.vocab_size, size=int(n)).tolist(), max_new_tokens=args.steps + 4))
    walls = []
    with torch.no_grad():
        eng.step()  # every prefill, then the first decode step, eagerly
        eng.step()  # the capture
        torch.cuda.synchronize()
        for _ in range(args.steps):
            t0 = time.perf_counter()
            eng.step()
            torch.cuda.synchronize()
            walls.append((time.perf_counter() - t0) * 1e3)
        progs = list(eng.programs.programs.values())
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(args.steps):
            for prog in progs:
                prog.graph.replay()
        end.record()
        torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / args.steps
    stats = eng.programs.stats()
    wall = float(np.median(walls))
    rec = {"root": args.root, "arch": cfg.name, "route": f"decode {mode}", "tenants": TENANTS,
           "slots": SLOTS, "programs": len(progs), "steps": args.steps,
           "wall_ms_p50": wall, "wall_ms_min": float(np.min(walls)),
           "wall_ms_max": float(np.max(walls)), "graph_device_ms": device_ms,
           "idle_share": 1 - device_ms / wall, "replays": stats["replays"],
           "captures": stats["captures"]}
    del eng, stacked
    return rec


def measure_step(args) -> list:
    """SSD-step alone at each (dtype, R, B) of chip_smoke.py's
    SSD_STEP_SEQS: ``chip_smoke.ssd_step_times`` (checked against its plain
    version, then timed from device memory and in L2), with the launches by
    variant and the library's register report."""
    import torch

    from repro_torch.kernels import _build, ops

    sys.path.append(str(Path(__file__).resolve().parents[1]))  # this checkout's chip_smoke.py
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 35)
    report = _build.build_log("ssd_step")
    regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
    recs = []
    for dtype in (torch.bfloat16, torch.float32):
        for R, B in cs.SSD_STEP_SEQS:
            ops.reset_counters()
            t = cs.ssd_step_times(ops, gen, dev, dtype, R, B)
            recs.append({"root": args.root, "route": "step", "op": "ssd_step",
                         "dtype": str(dtype)[6:], "R": R, "B": B, "heads": cs.SSD_HEADS, **t,
                         "launches_by_variant": dict(ops.COUNTERS["ssd_step"].variants),
                         "build_report": regs})
            torch.cuda.empty_cache()
    return recs


def measure_state(args) -> list:
    """K5-state and K5 alone at every piece size of chip_smoke.py's
    ``state_pieces`` (or ``--state-lengths``), by
    ``chip_smoke.piece_kernel_times``."""
    import torch

    from repro_torch.kernels import _build, ops

    sys.path.append(str(Path(__file__).resolve().parents[1]))  # this checkout's chip_smoke.py
    import chip_smoke as cs

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 13)
    report = _build.build_log("wkv6_state")
    regs = [ln.strip() for ln in report.splitlines() if "registers" in ln]
    recs = []
    lengths = ([int(x) for x in args.state_lengths.split(",")] if args.state_lengths
               else cs.state_pieces())
    for T in lengths:
        for op, rec in cs.piece_kernel_times(ops, gen, dev, T).items():
            recs.append({"root": args.root, "route": "state", "op": op, "heads": cs.WKV_HEADS,
                         **rec,
                         "build_report": regs if op == "wkv6_state" else []})
    return recs


def measure(arch: str, route: str, args) -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.config import get_config
    from repro_torch.core.tenancy import tenant_view
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    stacked = model.init_stacked([gen])
    params = tenant_view(stacked, 0)
    rng = np.random.RandomState(args.seed)
    lens = rng.randint(128, 1025, size=REQUESTS)
    prompts = [torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(1, int(n))), device=dev)
               for n in lens]
    build = {}
    if route == "whole":
        def prefill(tokens):
            return model.forward_prefill(params, tokens, CACHE_LEN)[0]
    elif route == "pieces":
        def prefill(tokens):
            pos, cache = 0, None
            for n in pieces(tokens.shape[1]):
                logits, cache = model.forward_prefill(
                    params, tokens[:, pos:pos + n], CACHE_LEN, caches=cache,
                    start=None if cache is None else pos)
                pos += n
            return logits
    elif route == "graphed":
        from repro_torch.serving import EngineConfig, MultiTenantEngine

        t0 = time.perf_counter()
        eng = MultiTenantEngine(model, stacked_params=stacked, graphs=True, config=EngineConfig(
            num_tenants=1, slots_per_tenant=1, cache_len=CACHE_LEN))
        st = eng.programs.stats()
        build = {"engine_build_s": time.perf_counter() - t0, "engine_route": eng.prefill_route,
                 **{k: v for k, v in st.items() if k.startswith("prefill_")}}

        def prefill(tokens):
            return eng._run_pieces(0, tokens)
    else:
        raise SystemExit(f"prefill_turns: no route {route!r}")
    walls = []
    with torch.no_grad():
        for tokens in prompts[:2]:
            prefill(tokens)
        torch.cuda.synchronize()
        for _ in range(args.repeats):
            for tokens in prompts:
                t0 = time.perf_counter()
                prefill(tokens)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        median = sorted(prompts, key=lambda t: t.shape[1])[REQUESTS // 2]
        ops.reset_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill(median)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    k4 = [e for e in kernels if "flash_" in e.key]
    rec = {
        "root": args.root, "arch": cfg.name, "route": route, **build,
        "prompt_lens": [int(n) for n in lens], "repeats": args.repeats,
        "wall_ms_p50": float(np.median(walls)), "wall_ms_mean": float(np.mean(walls)),
        "wall_ms_min": float(np.min(walls)), "wall_ms_max": float(np.max(walls)),
        "wall_ms_sum_16": float(np.sum(walls) / args.repeats),
        "profiled_tokens": int(median.shape[1]),
        "profiled_pieces": pieces(median.shape[1]) if route != "whole" else [],
        "profiled_wall_ms": prof_wall, "kernel_ms": busy, "idle_share": 1 - busy / prof_wall,
        "device_activities": sum(e.count for e in kernels),
        "k4_ms": sum(e.self_device_time_total for e in k4) / 1e3,
        "k4_launches": sum(e.count for e in k4),
        "launches_by_op": {k: dict(c.variants) for k, c in ops.COUNTERS.items() if c.launches},
        "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]],
    }
    return rec


if __name__ == "__main__":
    sys.exit(main())
