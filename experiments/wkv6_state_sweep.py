#!/usr/bin/env python3
"""The state pass (K5-state, ``wkv6_state``) on the card over lengths and segment counts.

    python3 experiments/wkv6_state_sweep.py
    python3 experiments/wkv6_state_sweep.py --heads 32 --lengths 742,32768

For rwkv6-1.6b's heads (N = V = 64, bf16 k and v as (1, H, T, N) views,
float32 w ~ N(-6, 1), a random state updated in place) it times the kernel
at every segment count from 1 to 8 that leaves each segment at least one
64-step tile (``wkv6_state.segments`` replaced by the count for the
launch), beside the count the rule picks, the row-block kernel (which
``wkv6_state.variant`` takes up to 512 steps) and the chunked K5 with
float32 w on the same inputs (the launch the state pass replaced in a bf16
prefill).
Times are device ms from ``chip_smoke.time_ms`` (CUDA events over
back-to-back launches queued behind a sleep kernel). Prints one JSON line
with the card's name and power limit. Needs a CUDA card; exits 2 without
one.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--heads", type=int, default=32)
    ap.add_argument("--lengths", default="64,256,512,742,1024,2048,8192,32768")
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("wkv6_state_sweep: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as cs
    from repro_torch.kernels import ops
    from repro_torch.kernels import wkv6_state as ws

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev)
    gen.manual_seed(args.seed)
    cs.WKV_HEADS = args.heads
    rule = ws.segments
    rows = []
    for T in (int(x) for x in args.lengths.split(",")):
        r, k, v, w, u = cs.wkv_inputs(gen, dev, torch.bfloat16, T, w_dtype=torch.float32,
                                      w_mean=cs.STATE_W_MEAN)
        state = torch.randn((args.heads, 64, 64), generator=gen, device=dev)
        by_count = {}
        for G in range(1, ws.MAX_SEGMENTS + 1):
            if G > max(1, T // ws.TILE):
                break
            ws.segments = lambda BH, T_, G=G: G
            try:
                by_count[G] = cs.time_ms(
                    lambda: ws.wkv6_state(k, v, w, state, state, kernel="segmented"), args.iters)
            finally:
                ws.segments = rule
        rows_ms = cs.time_ms(lambda: ws.wkv6_state(k, v, w, state, state, kernel="row_blocks"),
                             args.iters)
        prior = cs.time_ms(lambda: ops.wkv6_scan(r, k, v, w, u, init_state=state,
                                                 final_state=state), args.iters)
        nbytes, flops = cs.state_work(args.heads, T, 64, 64, torch.bfloat16)
        bound_ms, bound_by = cs.bound(nbytes, flops, "torch.float32")
        row = {"T": T, "variant": ws.variant(T), "rule": rule(args.heads, T),
               "ms_by_segments": by_count, "row_blocks_ms": rows_ms, "k5_float32_w_ms": prior,
               "bound_ms": bound_ms, "bound_by": bound_by}
        rows.append(row)
        print(f"T={T}: " + ", ".join(f"G={g} {ms:.4f}" for g, ms in by_count.items())
              + f" ms (rule {row['rule']}); row_blocks {rows_ms:.4f} ms (the variant rule: "
              f"{row['variant']}); K5 with float32 w {prior:.4f} ms; bound {bound_ms:.4f} "
              f"({bound_by})", flush=True)
        del r, k, v, w, u
    print(json.dumps({"wkv6_state_sweep": rows, "heads": args.heads,
                      "card": cs.gpu_identity()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
