"""The train step's time in one checkout of the port, for turns across
checkouts (parent, tree, tree, parent in one call).

    python3 experiments/train_step_turns.py --root DIR [--arch stablelm-1.6b,rwkv6-1.6b]

Imports ``repro_torch`` from ``DIR/src`` (this checkout, or a parent unpacked
with ``git archive`` into a directory ``.gitignore`` lists) and builds its
kernels. For each architecture, at full width and depth in bf16 with seeded
weights, at ``chip_smoke.py``'s training shapes (stablelm-1.6b 4 x 1024,
rwkv6-1.6b 4 x 512 tokens, remat "block"), it runs the train step as a
graphed ``TrainProgram`` (phase 10e's): one eager step, a capture, then
``--steps`` steady steps by the host clock to a synchronize, and as many
replays back to back by CUDA events (the step's device time; idle share = 1
- device / wall). Then ``adamw_update`` alone, eagerly, on one step's
gradients, by CUDA events: the optimizer's device time a step. Prints one
JSON line per architecture with the card's name and power limit. Needs the
card.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ARCHS = {"stablelm-1.6b": (4, 1024), "rwkv6-1.6b": (4, 512)}  # chip_smoke.TRAIN_ARCHS


def card() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]


def measure(arch: str, steps: int, seed: int) -> dict:
    import numpy as np
    import torch

    from repro_torch.config import get_config
    from repro_torch.models import build_model
    from repro_torch.training import SyntheticTokenStream, make_train_step
    from repro_torch.training import graphs as tg
    from repro_torch.training.optimizer import adamw_init, adamw_update, lr_schedule
    from repro_torch.tree import tree_leaves

    batch, seq = ARCHS[arch]
    dev = torch.device("cuda", 0)
    cfg = get_config(arch)
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    params = model.init(gen)
    step_fn = make_train_step(model, base_lr=1e-3, warmup_steps=5, total_steps=1000)
    prog = tg.train_program(step_fn, params, adamw_init(params), (batch, seq), dev, True)
    data = iter(SyntheticTokenStream(cfg.vocab_size, seq, batch, seed=seed + 3))
    for _ in range(2):  # the eager step, then the capture (and its replay)
        prog.run(*next(data))
    batches = [next(data) for _ in range(steps)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for tok, lab in batches:
        prog.run(tok, lab)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) / steps * 1e3
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(steps):
        prog.graph.replay()
    end.record()
    torch.cuda.synchronize()
    device_ms = start.elapsed_time(end) / steps
    loss = float(prog.run(*next(data))["loss"])

    # the optimizer alone: adamw_update on one step's gradients, eagerly
    leaves = tree_leaves(prog.params)
    tok, lab = (torch.as_tensor(np.asarray(a), device=dev).long() for a in next(data))
    loss_t, _ = model.forward_train(prog.params, tok, lab)
    grads = torch.autograd.grad(loss_t, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g.contiguous() for p, g in zip(leaves, grads)]
    del loss_t
    opt = prog.opt
    lr = lr_schedule(opt.step, 1e-3, 5, 1000)

    def update():
        adamw_update(grads, opt, prog.params, lr)
    update()
    torch.cuda.synchronize()
    start.record()
    for _ in range(3):
        update()
    end.record()
    torch.cuda.synchronize()
    opt_ms = start.elapsed_time(end) / 3
    rec = {"arch": arch, "batch": batch, "seq": seq, "leaves": len(leaves),
           "graph_wall_ms": wall_ms, "graph_device_ms": device_ms,
           "idle": 1 - device_ms / wall_ms, "optimizer_device_ms": opt_ms, "loss": loss,
           "steps": steps}
    prog.release()
    del prog, params, grads, leaves, model
    torch.cuda.empty_cache()
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", required=True, help="the checkout whose src/repro_torch to time")
    ap.add_argument("--arch", default=",".join(ARCHS))
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root / "src"))
    import torch

    if not torch.cuda.is_available():
        print("train_step_turns: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels import _build

    t0 = time.perf_counter()
    _build.build()
    built = time.perf_counter() - t0
    name = card()
    for arch in args.arch.split(","):
        rec = measure(arch, args.steps, args.seed)
        rec.update(root=str(args.root), build_s=built, card=name)
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
