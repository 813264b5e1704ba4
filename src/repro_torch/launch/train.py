"""Training launcher: the train loop on one device.

The JAX package's ``python -m repro.launch.train`` without its mesh (the
port's single-card path has none yet): a reduced config in float32, AdamW
on a warmup-cosine schedule, batches from ``SyntheticTokenStream``. It runs
on the card by default, where every attention layer runs K4 forward and
backward and every RWKV-6 layer K5, and the step (the reference's
``@jax.jit def step``) is a ``training.graphs.TrainProgram``: captured once
as a CUDA graph and replayed (``--graphs auto``, the default, or ``on``),
or run eagerly (``--graphs off``). ``--device cpu`` runs the plain PyTorch
versions, eagerly.

    PYTHONPATH=src python -m repro_torch.launch.train --arch stablelm-1.6b \\
        --steps 100 --batch 8 --seq 128 --smoke
    PYTHONPATH=src python -m repro_torch.launch.train --device cpu --steps 5
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.config import get_config, smoke_variant
from repro_torch.models import build_model
from repro_torch.training import SyntheticTokenStream
from repro_torch.training.graphs import train_program
from repro_torch.training.optimizer import adamw_init
from repro_torch.training.train_loop import make_train_step

GRAPHS = {"auto": None, "on": True, "off": False}  # --graphs -> serving.graphs.use_graphs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="reduced config (the reference's launcher trains only these)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    ap.add_argument("--graphs", choices=sorted(GRAPHS), default="auto",
                    help="the step as a CUDA graph: auto (on the card), on, off (eager)")
    args = ap.parse_args(argv)

    cfg = smoke_variant(get_config(args.arch))
    cfg = dataclasses.replace(cfg, dtype="float32")
    model = build_model(cfg, device=args.device)
    print(f"training {cfg.name} on {model.device}")

    gen = torch.Generator(device=model.device)
    gen.manual_seed(0)
    params = model.init(gen)
    opt = adamw_init(params)
    step = make_train_step(model, base_lr=args.lr, warmup_steps=10, total_steps=args.steps)
    prog = train_program(step, params, opt, (args.batch, args.seq), model.device,
                         GRAPHS[args.graphs])
    data = SyntheticTokenStream(cfg.vocab_size, args.seq, args.batch, seed=0)
    t0 = time.perf_counter()
    for i, (tok, lab) in zip(range(args.steps), data):
        metrics = prog.run(tok, lab)
        if i % max(args.steps // 10, 1) == 0:
            print(f"step {i:4d} loss {float(metrics['loss']):7.4f} "
                  f"({time.perf_counter()-t0:5.1f}s)")
    print("done")


if __name__ == "__main__":
    main()
