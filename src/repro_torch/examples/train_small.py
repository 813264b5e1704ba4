"""End-to-end training script: train a small model for a few hundred steps
on the synthetic pipeline, with checkpointing; the port of
``examples/train_small.py``.

The step runs through ``repro_torch.training.train``: on the card captured
once as a CUDA graph and replayed, every attention layer on K4 forward and
backward (every RWKV-6 layer on K5); ``--device cpu`` runs the kernels'
plain versions, eagerly.

    PYTHONPATH=src python -m repro_torch.examples.train_small --steps 300
    PYTHONPATH=src python -m repro_torch.examples.train_small --arch rwkv6-1.6b --steps 100
    PYTHONPATH=src python -m repro_torch.examples.train_small --device cpu --steps 20
"""

import argparse
import dataclasses
import os
import tempfile

from repro_torch.config import get_config, smoke_variant
from repro_torch.models import build_model
from repro_torch.training import SyntheticTokenStream, train

SEED = 0


def default_checkpoint() -> str:
    """A file of this process's own under the temporary directory."""
    return os.path.join(tempfile.gettempdir(), f"repro_torch_train_small_{os.getpid()}.msgpack")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="stablelm-1.6b")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--checkpoint", default=None,
                    help="checkpoint file (default: one of this process's own under the "
                         "temporary directory)")
    ap.add_argument("--device", default="cuda",
                    help="torch device; 'cpu' runs the kernels' plain versions")
    args = ap.parse_args(argv)
    checkpoint = args.checkpoint or default_checkpoint()

    base = get_config(args.arch)
    cfg = smoke_variant(base, num_layers=args.layers, d_model=args.d_model)
    cfg = dataclasses.replace(cfg, vocab_size=min(base.vocab_size, 8192), dtype="float32")
    model = build_model(cfg, device=args.device)
    n_params = cfg.param_count()
    print(f"training {cfg.name}: {cfg.num_layers}L d={cfg.d_model} "
          f"vocab={cfg.vocab_size} (~{n_params/1e6:.1f}M params) "
          f"batch={args.batch} seq={args.seq}")

    data = SyntheticTokenStream(
        vocab_size=cfg.vocab_size, seq_len=args.seq, batch_size=args.batch, seed=SEED
    )
    state = train(
        model, data,
        steps=args.steps, seed=SEED, base_lr=args.lr, warmup_steps=max(args.steps // 10, 1),
        log_every=max(args.steps // 20, 1),
        checkpoint_path=checkpoint, checkpoint_every=100,
    )
    print(f"done at step {state.step}; checkpoint at {checkpoint}")
    return state


if __name__ == "__main__":
    main()
