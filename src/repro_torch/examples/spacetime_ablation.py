"""Ablation of the dynamic scheduler's knobs (paper section 4); the port of
``examples/spacetime_ablation.py``.

Sweeps the batching window and R-bucketing policy over a stochastic trace
and reports the latency/throughput/compile trade-off each knob controls:

  * window=0           -> per-arrival dispatch (degenerates toward
                          space-only: many small super-kernels)
  * window=inf(ish)    -> offline batching (max merge, worst latency)
  * r_bucketing=exact  -> one compile per distinct R (cold-start heavy)
  * r_bucketing=pow2   -> padded merge, log2 many compiles

Every dispatch is one launch of K1 ``batched_gemm`` (float32: the ``simt``
kernel) on the card; ``--device cpu`` runs its plain version.

    PYTHONPATH=src python -m repro_torch.examples.spacetime_ablation
    PYTHONPATH=src python -m repro_torch.examples.spacetime_ablation --device cpu
"""

import argparse
import time

import numpy as np
import torch

from repro_torch.config import ScheduleConfig
from repro_torch.configs.paper_sgemm import PAPER_GEMM_SHAPES
from repro_torch.core import DynamicSpaceTimeScheduler, GemmProblem
from repro_torch.models.transformer import resolve_device

TENANTS = 8
EVENTS = 120
SEED = 0


def trace(sched: DynamicSpaceTimeScheduler, device, tenants=TENANTS, events=EVENTS, seed=SEED):
    g = PAPER_GEMM_SHAPES["resnet18_conv2_2"]
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    ws = [torch.randn((g.K, g.N), generator=gen, device=device, dtype=torch.float32)
          for _ in range(tenants)]
    xs = [torch.randn((g.M, g.K), generator=gen, device=device, dtype=torch.float32)
          for _ in range(4)]
    lat = []
    for _ in range(events):
        for _ in range(1 + rng.poisson(1.5)):
            t = int(rng.integers(tenants))
            sched.submit(GemmProblem(tenant_id=t, x=xs[int(rng.integers(4))], w=ws[t]))
        for p in sched.pump():
            lat.append(p.completion_time - p.arrival_time)
        time.sleep(0.0002)
    for p in sched.flush():
        lat.append(p.completion_time - p.arrival_time)
    return np.asarray(lat)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernel's plain version")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)  # raises with no card unless asked for another device

    print(f"{'window_ms':>10s} {'bucketing':>10s} {'p50 ms':>8s} {'p95 ms':>8s} "
          f"{'dispatches':>11s} {'hit rate':>9s}")
    rows = []
    for window_s in (0.0, 0.002, 0.02):
        for bucketing in ("pow2", "exact"):
            sched = DynamicSpaceTimeScheduler(ScheduleConfig(
                batching_window_s=window_s, r_bucketing=bucketing,
                max_superkernel_size=64))
            lat = trace(sched, device, TENANTS, EVENTS, SEED)
            rep = sched.report()
            rows.append((window_s, bucketing, lat, rep))
            print(f"{window_s*1e3:10.1f} {bucketing:>10s} "
                  f"{np.percentile(lat,50)*1e3:8.2f} {np.percentile(lat,95)*1e3:8.2f} "
                  f"{rep['dispatches']:11.0f} {rep['cache_hit_rate']:9.2f}")
    return rows


if __name__ == "__main__":
    main()
