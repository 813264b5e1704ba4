#!/usr/bin/env python3
"""One architecture's prefill on the card: host wall, kernel time and K4's share.

    python3 experiments/prefill_turns.py                       # zamba2-7b, this checkout
    python3 experiments/prefill_turns.py --root DIR --arch paligemma-3b

Builds ``--arch`` at full width and depth (bf16, seeded random weights, one
tenant) from the port under ``DIR/src`` (default: the checkout this script
lies in), so that two checkouts can be compared in one call with one copy
of the script. It prefills the 16 prompts ``chip_smoke.py``'s serving phases
draw for seed 0 (128-1024 random tokens) into a cache of 2048 positions,
twice unmeasured, then ``--repeats`` times each, every prefill timed on the
host clock around a synchronize. One prefill of the median prompt runs
under ``torch.profiler``: its kernel time, and K4's (``flash_attention``
kernels) time and launches. Prints one JSON line with the card's name and
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--arch", default="zamba2-7b")
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("prefill_turns: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    from repro_torch.config import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import build_model

    dev = torch.device("cuda", 0)
    cfg = get_config(args.arch)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed + 1)
    params = model.init(gen)
    rng = np.random.RandomState(args.seed)
    lens = rng.randint(128, 1025, size=REQUESTS)
    prompts = [torch.as_tensor(rng.randint(1, cfg.vocab_size, size=(1, int(n))), device=dev)
               for n in lens]
    walls = []
    with torch.no_grad():
        for tokens in prompts[:2]:
            model.forward_prefill(params, tokens, CACHE_LEN)
        torch.cuda.synchronize()
        for _ in range(args.repeats):
            for tokens in prompts:
                t0 = time.perf_counter()
                model.forward_prefill(params, tokens, CACHE_LEN)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t0) * 1e3)
        median = sorted(prompts, key=lambda t: t.shape[1])[REQUESTS // 2]
        ops.reset_counters()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.forward_prefill(params, median, CACHE_LEN)
            torch.cuda.synchronize()
            prof_wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels) / 1e3
    k4 = [e for e in kernels if "flash_" in e.key]
    k4_ms = sum(e.self_device_time_total for e in k4) / 1e3
    ident = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                           capture_output=True, text=True).stdout.strip()
    rec = {
        "root": args.root, "arch": cfg.name, "card": ident,
        "prompt_lens": [int(n) for n in lens], "repeats": args.repeats,
        "wall_ms_p50": float(np.median(walls)), "wall_ms_mean": float(np.mean(walls)),
        "wall_ms_min": float(np.min(walls)), "wall_ms_max": float(np.max(walls)),
        "profiled_tokens": int(median.shape[1]), "profiled_wall_ms": prof_wall,
        "kernel_ms": busy, "idle_share": 1 - busy / prof_wall,
        "k4_ms": k4_ms, "k4_launches": sum(e.count for e in k4),
        "k4_by_variant": dict(ops.COUNTERS["flash_attention"].variants),
        "top_kernels": [[e.key[:80], e.self_device_time_total / 1e3, e.count]
                        for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:5]],
    }
    print(json.dumps({"prefill_turns": rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
