"""End-to-end multi-tenant serving: R tenants of one architecture served by
the space-time engine with batched requests; the port of
``examples/multi_tenant_serving.py``.

This is the model-level form of the paper's mechanism: tenant weights are
STACKED and the decode step is ONE program over all of them, so every
projection/FFN GEMM executes as an inter-model batched super-kernel. On
the card that step is a CUDA graph, captured after its first run and
replayed (K3 ``decode_attention`` inside it), and every prefill runs K4
``flash_attention``; ``--device cpu`` runs the kernels' plain versions,
eagerly.

    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving --arch stablelm-1.6b -R 4
    PYTHONPATH=src python -m repro_torch.examples.multi_tenant_serving --device cpu
"""

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.config import get_config, smoke_variant
from repro_torch.models import build_model
from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine

SEED = 0


def tenant_params(model, tenants: int):
    """Each tenant's weights, from a generator on the model's device seeded
    with SEED + the tenant's index."""
    out = []
    for t in range(tenants):
        gen = torch.Generator(device=model.device)
        gen.manual_seed(SEED + t)
        out.append(model.init(gen))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("-R", "--tenants", type=int, default=4)
    ap.add_argument("--requests-per-tenant", type=int, default=4)
    ap.add_argument("--max-new-tokens", type=int, default=12)
    ap.add_argument("--mode", default="space_time", choices=["space_time", "time_only"])
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)

    cfg = dataclasses.replace(smoke_variant(get_config(args.arch)), dtype="float32")
    model = build_model(cfg, device=args.device)
    print(f"arch={args.arch} (reduced: {cfg.num_layers}L d={cfg.d_model}) "
          f"R={args.tenants} mode={args.mode}")

    engine = MultiTenantEngine(
        model, tenant_params(model, args.tenants),
        EngineConfig(num_tenants=args.tenants, slots_per_tenant=2,
                     cache_len=96, mode=args.mode),
    )

    rng = np.random.RandomState(SEED)
    t0 = time.perf_counter()
    for t in range(args.tenants):
        for _ in range(args.requests_per_tenant):
            engine.submit(InferenceRequest(
                tenant_id=t,
                prompt=list(rng.randint(1, cfg.vocab_size, size=8)),
                max_new_tokens=args.max_new_tokens,
            ))
    engine.run_until_drained()
    dt = time.perf_counter() - t0

    rep = engine.report()
    print(f"\nserved {rep['finished']:.0f} requests / "
          f"{rep['decode_tokens']:.0f} tokens in {dt:.1f}s "
          f"({rep['decode_tokens']/dt:.1f} tok/s)")
    print(f"p50 step latency {rep['p50_s']*1e3:.1f} ms   "
          f"p95 {rep['p95_s']*1e3:.1f} ms   "
          f"inter-tenant spread {rep['spread']:.1%}")
    for r in engine.finished[:3]:
        print(f"  tenant {r.tenant_id} req {r.request_id}: "
              f"prompt {r.prompt[:4]}... -> {r.generated}")
    return engine


if __name__ == "__main__":
    main()
