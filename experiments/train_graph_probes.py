"""Two probes of the captured train step (``repro_torch.training.graphs``) on
the card, at stablelm-1.6b's and rwkv6-1.6b's smoke variants widened to
d_model 512 (K4 ``wgmma`` at D 128, K5 ``chunked`` / ``cluster``), bf16,
2 × 64 tokens:

1. each CUDA graph capture mode (``thread_local``, ``relaxed``, ``global``):
   does the capture take the whole step, the K4/K5 backward kernels that
   autograd's device thread launches included? A graphed program and an
   eager one run 5 steps in lockstep from the same params; the script
   prints how many steps' loss, grad norm and lr are bitwise equal, whether
   every param and moment is, and what one replay launches;
2. whether ``torch.utils.checkpoint``'s default stash of CUDA's generator
   state (``preserve_rng_state=True``, what ``remat="block"`` calls) is
   allowed under capture: 3 graphed steps, or the error that stops them.

    python3 experiments/train_graph_probes.py        # on the card (~1 min after the build)
"""

from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

import torch  # noqa: E402
import torch.utils.checkpoint  # noqa: E402

from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import SyntheticTokenStream, make_train_step  # noqa: E402
from repro_torch.training import graphs as tg  # noqa: E402
from repro_torch.training.optimizer import adamw_init  # noqa: E402
from repro_torch.tree import tree_leaves, tree_map  # noqa: E402

SHAPE = (2, 64)
MODES = ("thread_local", "relaxed", "global")


def model_and_params(arch, dev):
    cfg = dataclasses.replace(smoke_variant(get_config(arch), d_model=512), dtype="bfloat16")
    model = build_model(cfg, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    return cfg, model, model.init(gen)


class ModeShare(tg.TrainShare):
    """``TrainShare`` whose capture runs in ``mode`` (``GraphShare.capture``
    otherwise)."""

    def __init__(self, device, mode):
        super().__init__(device)
        self.mode = mode

    def capture(self, step, tokens, labels):
        torch.cuda.synchronize(self.device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(self.device)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self.pool, stream=self.stream,
                              capture_error_mode=self.mode):
            out = step(tokens, labels)
        return graph, out, torch.cuda.memory_reserved(self.device) - reserved


def probe_mode(arch, mode, dev, steps=5):
    """Probe 1 for one capture mode."""
    cfg, model, params = model_and_params(arch, dev)
    twin = tree_map(lambda t: t.clone(), params)
    fn = make_train_step(model, base_lr=1e-3, warmup_steps=2, total_steps=100)
    share = ModeShare(dev, mode)
    eager = tg.TrainProgram(tg.TrainStep(fn, params, adamw_init(params)), SHAPE, dev)
    graph = tg.TrainProgram(tg.TrainStep(fn, twin, adamw_init(twin)), SHAPE, dev, share)
    data = iter(SyntheticTokenStream(cfg.vocab_size, SHAPE[1], SHAPE[0], seed=1))
    ops.reset_counters()
    try:
        same = 0
        for _ in range(steps):
            tok, lab = next(data)
            a, b = eager.run(tok, lab), graph.run(tok, lab)
            same += all(torch.equal(a[k], b[k]) for k in ("loss", "grad_norm", "lr"))
        state = all(torch.equal(x, y) for x, y in zip(
            tree_leaves(eager.params) + tree_leaves(eager.opt),
            tree_leaves(graph.params) + tree_leaves(graph.opt)))
        print(f"{arch} {mode}: steps bitwise {same}/{steps}, state equal {state}, a replay "
              f"launches {({k: dict(c.variants) for k, c in graph.launches.items()})}, "
              f"{graph.stats()}", flush=True)
    except Exception as ex:  # the probe reports a refused capture and goes on
        print(f"{arch} {mode}: FAILED: {type(ex).__name__}: {str(ex)[:300]}", flush=True)
    torch.cuda.synchronize()


def probe_rng_stash(dev, steps=3):
    """Probe 2: ``remat="block"`` with checkpointing's RNG stash forced on."""
    plain = torch.utils.checkpoint.checkpoint

    def stashing(*args, **kw):
        return plain(*args, **dict(kw, preserve_rng_state=True))
    torch.utils.checkpoint.checkpoint = stashing
    i = 0
    try:
        cfg, model, params = model_and_params("stablelm-1.6b", dev)
        prog = tg.train_program(make_train_step(model), params, adamw_init(params), SHAPE, dev,
                                True)
        data = iter(SyntheticTokenStream(cfg.vocab_size, SHAPE[1], SHAPE[0], seed=1))
        for i in range(steps):
            prog.run(*next(data))
        torch.cuda.synchronize()
        print(f"rng stash under capture: {steps} steps ran, {prog.stats()}", flush=True)
    except Exception as ex:  # the probe reports a refused capture
        print(f"rng stash under capture: FAILED at step {i}: {type(ex).__name__}: "
              f"{str(ex)[:300]}", flush=True)
    finally:
        torch.utils.checkpoint.checkpoint = plain


def main() -> int:
    if not torch.cuda.is_available():
        print("train_graph_probes: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    for arch in ("stablelm-1.6b", "rwkv6-1.6b"):
        for mode in MODES:
            probe_mode(arch, mode, dev)
    probe_rng_stash(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
