"""Float32 microbatch equivalence of rwkv6-1.6b's gradients, on the CPU: the
JAX package beside the PyTorch port's plain path, on the same weights.

The reference's check (``tests/test_launch.py::test_microbatch_equivalence``)
holds the gradients of k microbatches, summed and divided by k, to those of
the whole batch at rtol 1e-4, atol 1e-5. This script runs it at rwkv6-1.6b's
full width, cut to 2 layers, float32, a batch of 4 sequences and k = 4, with
a data-dependent decay (``w_lora_b`` ~ 0.1 N(0, 1)), random tokens and
labels: first through the JAX model, then through the port's plain path
(``plain_kernels=True``, ``launch.steps.loss_and_grads``) on the weights
converted through numpy. It prints, per leaf, the largest
|g_microbatch - g_whole| / (atol + rtol |g_whole|) of each: above 1 where the
reference's check fails.

    JAX_PLATFORMS=cpu PYTHONPATH=src python experiments/microbatch_f32.py --seq 256
    JAX_PLATFORMS=cpu PYTHONPATH=src python experiments/microbatch_f32.py --seq 256 \\
        --f64-matmul --port-only

``--f64-matmul`` runs the port's float32 ``torch.matmul`` products with
more than 64 terms in float64 (rounded back to float32), which takes away
the dependence of a product's rounding on its row count; ``--port-only``
skips the JAX side. Needs ~10 GB of memory and a few minutes on 8 cores.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np

RTOL, ATOL = 1e-4, 1e-5
ARCH, LAYERS, BATCH, K = "rwkv6-1.6b", 2, 4, 4


def excess(got, want):
    return [float((np.abs(a.astype(np.float64) - b) / (ATOL + RTOL * np.abs(b))).max())
            for a, b in zip(got, want)]


def cut(cfg, dtype="float32"):
    pattern = cfg.block_pattern[:LAYERS] if cfg.block_pattern else cfg.block_pattern
    return dataclasses.replace(cfg, num_layers=LAYERS, dtype=dtype, block_pattern=pattern)


def reference_params(seed, rng):
    """The JAX init of the cut model (numpy leaves) with a live decay drawn
    from ``rng``."""
    import jax

    from repro.config import get_config
    from repro.models import build_model

    model = build_model(cut(get_config(ARCH)), remat="none")
    params = jax.tree.map(np.asarray, model.init(jax.random.PRNGKey(seed)))

    def live(path, a):
        if getattr(path[-1], "key", None) == "w_lora_b":
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a

    return model, jax.tree_util.tree_map_with_path(live, params)


def jax_side(model, params, tok, lab):
    import jax
    import jax.numpy as jnp

    p = jax.tree.map(jnp.asarray, params)
    grad = jax.jit(jax.value_and_grad(lambda p, t, l: model.forward_train(p, t, l)[0]))
    loss, grads = grad(p, tok, lab)
    mb_loss, mb_grads = 0.0, jax.tree.map(jnp.zeros_like, p)
    for i in range(K):
        rows = slice(i * BATCH // K, (i + 1) * BATCH // K)
        l, g = grad(p, tok[rows], lab[rows])
        mb_loss += l / K
        mb_grads = jax.tree.map(lambda a, b: a + b / K, mb_grads, g)
    gap = abs(float(mb_loss) - float(loss)) / abs(float(loss))
    return gap, excess([np.asarray(x) for x in jax.tree.leaves(mb_grads)],
                       [np.asarray(x) for x in jax.tree.leaves(grads)])


def port_side(params, tok, lab, f64_matmul):
    import torch

    from repro_torch.config import get_config
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import build_model
    from repro_torch.models.convert import params_from_jax_numpy, params_to_scan

    if f64_matmul:
        matmul = torch.matmul

        def matmul64(a, b):
            if a.dtype == b.dtype == torch.float32 and a.shape[-1] > 64:
                return matmul(a.double(), b.double()).float()
            return matmul(a, b)
        torch.matmul = matmul64
    cfg = cut(get_config(ARCH))
    plain = build_model(cfg, device="cpu", plain_kernels=True)
    scan = params_to_scan(cfg, params_from_jax_numpy(cfg, params, device="cpu"))
    t, l = torch.as_tensor(tok), torch.as_tensor(lab)
    loss, grads = loss_and_grads(plain, scan, t, l)
    mb_loss, mb_grads = loss_and_grads(plain, scan, t, l, microbatch=K)
    gap = abs(float(mb_loss) - float(loss)) / abs(float(loss))
    return gap, excess([g.numpy() for g in mb_grads], [g.numpy() for g in grads])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--seed", type=int, default=120, help="the JAX init's key")
    ap.add_argument("--data-seed", type=int, default=7,
                    help="numpy seed of the live decay, then the tokens and labels")
    ap.add_argument("--f64-matmul", action="store_true")
    ap.add_argument("--port-only", action="store_true")
    args = ap.parse_args(argv)

    import jax

    rng = np.random.RandomState(args.data_seed)
    model, params = reference_params(args.seed, rng)
    names = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_flatten_with_path(params)[0]]
    tok = rng.randint(1, model.cfg.vocab_size, size=(BATCH, args.seq)).astype(np.int32)
    lab = rng.randint(1, model.cfg.vocab_size, size=(BATCH, args.seq)).astype(np.int32)
    t0 = time.perf_counter()
    ref = None if args.port_only else jax_side(model, params, tok, lab)
    t1 = time.perf_counter()
    port = port_side(params, tok, lab, args.f64_matmul)
    t2 = time.perf_counter()
    print(f"{ARCH}, {LAYERS} layers, float32, {BATCH} x {args.seq}, microbatch {K} vs 1 "
          f"(rtol {RTOL}, atol {ATOL}); reference {t1 - t0:.0f} s, port {t2 - t1:.0f} s"
          + (", port products in float64" if args.f64_matmul else ""))
    ref_gap = ref[0] if ref else float("nan")
    print(f"  loss relative gap: reference {ref_gap:.2e}, port {port[0]:.2e}")
    for i, name in enumerate(names):
        r = ref[1][i] if ref else float("nan")
        flag = "  <- beyond" if max(r if ref else 0.0, port[1][i]) > 1 else ""
        print(f"  {name:40s} reference {r:8.4f}  port {port[1][i]:8.4f}{flag}")
    print(json.dumps({"seq": args.seq, "data_seed": args.data_seed,
                      "f64_matmul": args.f64_matmul, "leaves": names,
                      "reference": ref[1] if ref else None, "port": port[1]}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
