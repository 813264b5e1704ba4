"""The engine's decode programs (``repro_torch.serving.graphs``) on the CPU.

CUDA graphs exist only on the card, where ``chip_smoke.py`` holds graphed
engines against eager ones. Here: the rule that picks graphs or eager; the
launch counters under capture and replay, and the program's order (one
eager warm-up, one capture, then replays) through a stand-in for the two
CUDA calls (``GraphShare.warm_up``, ``GraphShare.capture``) that records
without running and replays by running; the staging of tokens and lengths
through the programs' static buffers, with the eager engine's greedy tokens
equal to the JAX engine's; and that a step advances RWKV and Mamba2 state
exactly once, graph route included.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

import test_torch_serving as ts  # noqa: E402
from test_torch_serving import rwkv_tenants, tenants  # noqa: E402,F401  (fixtures)

from repro_torch.config import BlockKind  # noqa: E402
from repro_torch.core.tenancy import tenant_view  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels._build import OpCounter  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402

CPU = torch.device("cpu")


# ------------------------------------------------------------------ the rule
@pytest.mark.parametrize("device,graphs_arg,want", [
    ("cuda", None, True), ("cuda:0", None, True), ("cuda", False, False), ("cuda", True, True),
    ("cpu", None, False), ("cpu", False, False), ("meta", None, False), ("meta", False, False),
])
def test_route_rule(device, graphs_arg, want):
    assert graphs.use_graphs(torch.device(device), graphs_arg) is want


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_graphs_off_the_card_raise(device):
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        graphs.use_graphs(torch.device(device), True)


def test_engine_asking_for_graphs_on_the_cpu_raises(tenants):
    cfg, _, _, model, tparams = tenants
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA device"):
        MultiTenantEngine(model, tparams, EngineConfig(num_tenants=ts.R), graphs=True)
    eng = MultiTenantEngine(model, tparams, EngineConfig(num_tenants=ts.R))
    assert eng.programs.graphed is False and eng.programs.share is None


# ------------------------------------------------- a stand-in for the card
class Toy:
    """A decode step with state that advances: ``state += tokens``, logits
    ``state * lengths``; two split_kv launches and one plain call of
    decode_attention a pass. ``mode`` says what a call does: "run" (count
    and compute, as an eager call), "record" (count only, as a capture) or
    "replay" (compute only: a replay runs no Python)."""

    def __init__(self, n):
        self.state = torch.zeros(n, dtype=torch.int64)
        self.mode = "run"
        self.inputs = []

    def __call__(self, tokens, lengths):
        self.inputs.append((tokens.data_ptr(), lengths.data_ptr()))
        if self.mode != "replay":
            c = ops.COUNTERS["decode_attention"]
            c.launched("split_kv")
            c.launched("split_kv")
            c.plain_calls += 1
        if self.mode == "record":
            return torch.empty_like(self.state)
        self.state += tokens
        return self.state * lengths


class FakeGraph:
    def __init__(self, replay):
        self.replay = replay


class FakeShare:
    """``GraphShare`` without a card: the warm-up runs the step; a capture
    records it (runs nothing) and returns a graph whose replay runs it into
    the static output."""

    def __init__(self, fail=False):
        self.fail = fail
        self.warm_ups = 0

    def warm_up(self, step, tokens, lengths):
        self.warm_ups += 1
        return step(tokens, lengths)

    def capture(self, step, tokens, lengths):
        step.mode = "record"
        out = step(tokens, lengths)
        step.mode = "run"
        if self.fail:
            raise RuntimeError("operation not permitted when stream is capturing")

        def replay():
            step.mode = "replay"
            out.copy_(step(tokens, lengths))
            step.mode = "run"
        return FakeGraph(replay), out, 4096


@pytest.fixture
def counters():
    saved = {k: c.copy() for k, c in ops.COUNTERS.items()}
    ops.reset_counters()
    yield ops.COUNTERS["decode_attention"]
    for k, c in ops.COUNTERS.items():
        c.reset()
        c.add(saved[k])


def test_capture_counts_nothing_and_each_replay_counts_the_graph(counters):
    toy = Toy(3)
    prog = graphs.StepProgram(toy, (3,), CPU, FakeShare())
    rng = np.random.default_rng(0)
    staged = []
    for i in range(6):
        tok, lens = rng.integers(0, 50, 3), rng.integers(1, 9, 3)
        staged.append(tok)
        got = prog.run(tok, lens)
        assert torch.equal(got, torch.as_tensor(np.sum(staged, axis=0) * lens))
        # the step always reads the program's static buffers, staged by copy
        assert toy.inputs[-1] == (prog.tokens.data_ptr(), prog.lengths.data_ptr())
        assert prog.tokens.tolist() == tok.tolist() and prog.lengths.tolist() == lens.tolist()
        if i == 0:  # the eager warm-up
            assert (prog.eager_passes, prog.captures, prog.replays) == (1, 0, 0)
            assert (counters.launches, counters.variants, counters.plain_calls) == (
                2, {"split_kv": 2}, 1)
        if i == 1:  # captured (counted nothing), then replayed once
            assert (prog.eager_passes, prog.captures, prog.replays) == (1, 1, 1)
            assert prog.launches["decode_attention"].variants == {"split_kv": 2}
            assert prog.launches["decode_attention"].plain_calls == 1
    # each call advanced the state once: 1 eager pass + 5 replays, no extra
    assert torch.equal(toy.state, torch.as_tensor(np.sum(staged, axis=0)))
    assert (prog.eager_passes, prog.captures, prog.replays) == (1, 1, 5)
    assert (counters.launches, counters.variants, counters.plain_calls) == (
        12, {"split_kv": 12}, 6)
    for k in range(1, 4):  # k bare replays add k x the graph's launches
        before = counters.copy()
        for _ in range(k):
            prog.replay()
        d = counters.since(before)
        assert (d.launches, d.variants, d.plain_calls) == (2 * k, {"split_kv": 2 * k}, k)
    assert prog.pool_bytes == 4096 and prog.capture_s > 0


def test_eager_route_never_captures(counters):
    toy = Toy(2)
    prog = graphs.StepProgram(toy, (2,), CPU)
    for i in range(4):
        prog.run(np.array([1, 2]), np.array([3, 4]))
    assert (prog.eager_passes, prog.captures, prog.replays, prog.graph) == (4, 0, 0, None)
    assert counters.variants == {"split_kv": 8}
    assert torch.equal(toy.state, torch.tensor([4, 8]))


def test_a_failed_capture_raises_and_counts_nothing(counters):
    toy = Toy(2)
    prog = graphs.StepProgram(toy, (2,), CPU, FakeShare(fail=True))
    prog.run(np.array([1, 1]), np.array([1, 1]))
    before = counters.copy()
    with pytest.raises(RuntimeError, match="capturing"):
        prog.run(np.array([1, 1]), np.array([1, 1]))
    d = counters.since(before)
    assert (d.launches, d.plain_calls, d.variants) == (0, 0, {})
    assert prog.graph is None and prog.replays == 0 and prog.eager_passes == 1
    assert torch.equal(toy.state, torch.tensor([1, 1]))  # nothing ran eagerly instead


def test_opcounter_add_and_since():
    c = OpCounter()
    c.launched("wgmma")
    snap = c.copy()
    c.launched("wgmma")
    c.launched("cuda_core")
    d = c.since(snap)
    assert (d.launches, d.variants) == (2, {"wgmma": 1, "cuda_core": 1})
    c.add(d, -1)
    assert (c.launches, c.variants) == (1, {"wgmma": 1})
    c.add(d, 3)
    assert (c.launches, c.variants) == (7, {"wgmma": 4, "cuda_core": 3})


def test_opcounter_counts_by_size_through_capture_and_replay():
    """The by-size counts follow the by-variant ones: taken out at capture,
    added back once a replay, and dropped where they come to 0."""
    c = OpCounter()
    c.launched("segmented", size=64)
    snap = c.copy()
    c.launched("segmented", size=512)
    c.launched("segmented", size=64)
    c.launched("segmented")  # a wrapper that names no size
    d = c.since(snap)
    assert (d.launches, d.sizes) == (3, {512: 1, 64: 1})
    c.add(d, -1)
    assert (c.launches, c.variants, c.sizes) == (1, {"segmented": 1}, {64: 1})
    c.add(d, 2)
    assert (c.launches, c.sizes) == (7, {64: 3, 512: 2})
    c.reset()
    assert (c.launches, c.variants, c.sizes) == (0, {}, {})


# --------------------------------------------- the engine on the CPU: staging
@pytest.fixture(scope="module")
def zamba_tenants():
    return ts._tenants("zamba2-7b", num_layers=4)


def _arch(request, arch):
    name = {"stablelm-1.6b": "tenants", "rwkv6-1.6b": "rwkv_tenants",
            "zamba2-7b": "zamba_tenants"}[arch]
    return request.getfixturevalue(name)


def _watch_inputs(eng):
    """Record, per decode pass, the pointers of the tokens and lengths the
    model read (``forward_decode`` runs through ``forward_decode_tenants``)."""
    seen = []
    fn = eng.model.forward_decode_tenants

    def watched(params, tok, caches, lens):
        seen.append((tok.data_ptr(), lens.data_ptr()))
        return fn(params, tok, caches, lens)
    eng.model.forward_decode_tenants = watched
    return seen


def _unwatch(eng):
    del eng.model.forward_decode_tenants


@pytest.mark.parametrize("mode", ["space_time", "time_only"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b", "zamba2-7b"])
def test_staged_engine_matches_jax_engine(request, arch, mode):
    cfg, jm, jparams, model, tparams = _arch(request, arch)
    prompts = ts._prompts(3)
    jeng = ts._serve_jax(jm, jparams, prompts, mode=mode)
    eng = MultiTenantEngine(model, tparams, EngineConfig(
        num_tenants=ts.R, slots_per_tenant=ts.SLOTS, cache_len=ts.CACHE_LEN, mode=mode))
    seen = _watch_inputs(eng)
    try:
        for t, p in prompts:
            eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=ts.NEW))
        eng.run_until_drained()
    finally:
        _unwatch(eng)
    assert ts._tokens(eng) == ts._tokens(jeng)
    stats = eng.programs.stats()
    progs = eng.programs.programs
    assert set(progs) == ({None} if mode == "space_time" else set(range(ts.R)))
    assert stats["captures"] == stats["replays"] == 0
    assert stats["eager_passes"] == stats["decode_passes"] == len(seen) > 0
    buffers = {(p.tokens.data_ptr(), p.lengths.data_ptr()) for p in progs.values()}
    assert set(seen) == buffers  # every pass read a program's static buffers


# ------------------------------------- a step advances recurrent state once
class CpuShare(FakeShare):
    """``GraphShare`` for an engine on the CPU: a capture runs the step but
    puts every cache back as it was (a capture runs nothing), and its replay
    runs the step into the static output with no Python-side count."""

    def __init__(self, caches):
        super().__init__()
        self.caches = caches

    def capture(self, step, tokens, lengths):
        saved = [c.clone() for layers in self.caches.values() for c in layers]
        out = step(tokens, lengths)
        for c, s in zip((c for layers in self.caches.values() for c in layers), saved):
            c.copy_(s)

        def replay():
            with ops.capturing():
                out.copy_(step(tokens, lengths))
        return FakeGraph(replay), out, 0


def _graphed(eng):
    """Put ``eng``'s decode programs on the graph route, with ``CpuShare``."""
    eng.programs.graphed = True
    eng.programs.share = CpuShare(eng.caches)


@pytest.mark.parametrize("graphed", [False, True], ids=["eager", "graph_route"])
@pytest.mark.parametrize("mode", ["space_time", "time_only"])
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "zamba2-7b"])
def test_a_step_advances_state_exactly_once(request, arch, mode, graphed, counters):
    """The caches after N engine steps equal N single decode steps of the
    model (the mode's own: merged, or each tenant's) from the caches the
    first step left, fed the tokens and lengths the engine staged."""
    cfg, jm, jparams, model, tparams = _arch(request, arch)
    n_steps = 4
    eng = MultiTenantEngine(model, tparams, EngineConfig(
        num_tenants=ts.R, slots_per_tenant=ts.SLOTS, cache_len=ts.CACHE_LEN, mode=mode))
    if graphed:
        _graphed(eng)
    for t, p in ts._prompts(5, n=ts.R * ts.SLOTS):
        eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=n_steps + 3))
    eng.step()  # every prefill, then the first decode step (eager on either route)
    start = {k: [c.clone() for c in layers] for k, layers in eng.caches.items()}
    fed = []
    for prog_key in ([None] if mode == "space_time" else range(ts.R)):
        prog = eng.decode_program(prog_key)
        stage = prog.stage

        def staged(tok, lens, _stage=stage, _k=prog_key):
            fed.append((_k, np.array(tok), np.array(lens)))
            _stage(tok, lens)
        prog.stage = staged
    for _ in range(n_steps):
        eng.step()
    stats = eng.programs.stats()
    n_progs = 1 if mode == "space_time" else ts.R
    assert stats["decode_passes"] == n_progs * (n_steps + 1)
    assert stats["eager_passes"] == (n_progs if graphed else n_progs * (n_steps + 1))
    assert stats["captures"] == (n_progs if graphed else 0)
    if arch == "zamba2-7b":  # launches count per pass, replays included
        n_attn = sum(1 for k in eng.model.blocks if k == BlockKind.HYBRID_SHARED_ATTN)
        assert counters.plain_calls == n_attn * stats["decode_passes"]
    want = start
    with torch.no_grad():
        for key, tok, lens in fed:
            tok, lens = torch.as_tensor(tok), torch.as_tensor(lens)
            if key is None:
                model.forward_decode_tenants(eng.stacked_params, tok, want, lens)
            else:
                view = {k: [c[key] for c in layers] for k, layers in want.items()}
                model.forward_decode(tenant_view(eng.stacked_params, key), tok, view, lens)
    for name, layers in eng.caches.items():
        for got, ref in zip(layers, want[name]):
            assert torch.equal(got, ref), name


# ------------------------------------ chip_smoke.py's graph checks, rehearsed
class _Event:
    def __init__(self, **_):
        pass

    def record(self):
        pass

    def elapsed_time(self, _other):
        return 1.0


class ModelShare(CpuShare):
    """``CpuShare`` whose replay runs no wrapper a caller put on the model:
    a replay on the card runs no Python (``run_engine`` counts the model's
    decode calls by such a wrapper)."""

    def __init__(self, caches, model):
        super().__init__(caches)
        self.model = model

    def capture(self, step, tokens, lengths):
        graph, out, reserved = super().capture(step, tokens, lengths)
        inner = graph.replay

        def replay():
            wrapper = self.model.__dict__.pop("forward_decode_tenants", None)
            try:
                inner()
            finally:
                if wrapper is not None:
                    self.model.forward_decode_tenants = wrapper
        graph.replay = replay
        return graph, out, reserved


def test_phase_serving_graph_checks_rehearsed(monkeypatch):
    """Phase 7b's serving of zamba2 (Mamba2 state and a shared attention
    block) at smoke width on the CPU, every engine on the graph route with
    ``ModelShare`` for the card: the main path's eager-once-then-replays
    check, the launch counts (the attention kernels and SSD-scan and
    SSD-step stood in for by counting plain versions), and
    ``graph_checks`` (graphed against eager in lockstep, both controls
    caught) in both modes, into the ``graphs`` line."""
    import dataclasses
    import json
    from pathlib import Path

    root = Path(__file__).resolve().parents[1]
    monkeypatch.syspath_prepend(str(root))
    import chip_smoke

    import repro_torch.config
    from repro_torch.config import smoke_variant
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref, ssd
    from repro_torch.serving import engine as engine_mod

    for name in ("synchronize", "_sleep", "empty_cache", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a, **k: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a, **k: 0)
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    get = repro_torch.config.get_config
    monkeypatch.setattr(repro_torch.config, "get_config", lambda arch: dataclasses.replace(
        smoke_variant(get(arch), num_layers=4), dtype="bfloat16"))

    def flash(q, k, v, *, causal=True, window=0, scale=None, logit_softcap=0.0, q_offset=None,
              kernel=None):
        fa.counter.launched(kernel or fa.variant(q.dtype, q.shape[-1]))
        return ref.attention(q, k, v, causal=causal, window=window, scale=scale,
                             logit_softcap=logit_softcap, q_offset=q_offset)

    def decode(q, kc, vc, lengths, *, scale=None, kernel=None):
        da.counter.launched(
            kernel or da.variant(q.dtype, q.shape[-1], q.shape[1] // kc.shape[1]))
        return ref.decode_attention(q, kc, vc, lengths, scale=scale)

    def scan(xh, dt, A, Bm, Cm, chunk, init_state=None):
        ssd.scan_counter.launched(ssd.SCAN_VARIANT)
        return ref.ssd_scan(xh, dt, A, Bm, Cm, chunk, init_state)

    def step(p, cache, z, xs, Bm, Cm, dt):
        ssd.step_counter.launched(ssd.STEP_VARIANT)
        return ref.ssd_step(p, cache, z, xs, Bm, Cm, dt)

    for mod, name, fn in ((ops, "flash_attention", flash), (fa, "flash_attention", flash),
                          (ops, "decode_attention", decode), (da, "decode_attention", decode),
                          (ops, "ssd_scan", scan), (ops, "ssd_step", step)):
        monkeypatch.setattr(mod, name, fn)
    # the graph route on the CPU, with the card's two calls stood in for:
    # the engine's build captures its prefill programs (their stand-in
    # captures put back no cache: the engine zeroes its scratch cache after
    # them), its decode captures put the stacked caches back
    monkeypatch.setattr(graphs, "use_graphs", lambda device, g=None: g is not False)
    building = {}
    monkeypatch.setattr(graphs, "GraphShare", lambda device: ModelShare({}, building["model"]))
    init = engine_mod.MultiTenantEngine.__init__

    def on_graph_route(self, model, *args, **kwargs):
        building["model"] = model
        init(self, model, *args, **kwargs)
        if self.programs.graphed:
            self.programs.share.caches = self.caches
    monkeypatch.setattr(engine_mod.MultiTenantEngine, "__init__", on_graph_route)
    monkeypatch.setattr(chip_smoke, "MAX_NEW", 10)
    monkeypatch.setattr(chip_smoke, "GRAPH_REPORT", {})
    monkeypatch.setattr(chip_smoke, "PREFILL_REPORT", {})
    # a cache of 256 and prompts cut to 200 tokens: each engine's build
    # captures 4 tenants x 8 piece sizes at smoke width in seconds
    monkeypatch.setattr(chip_smoke, "CACHE_LEN", 256)
    serve = chip_smoke.serve_prompts

    def short_prompts(cfg, seed, n=None):
        prompts, lens = serve(cfg, seed, n)
        return [(t, p[:200]) for t, p in prompts], [min(n, 200) for n in lens]
    monkeypatch.setattr(chip_smoke, "serve_prompts", short_prompts)
    ops.reset_counters()
    cfg = repro_torch.config.get_config("zamba2-7b")
    chip_smoke.phase_serving(CPU, 0, ops, "zamba2-7b",
                             flash_variant=fa.variant(torch.bfloat16, cfg.head_dim))
    report = chip_smoke.GRAPH_REPORT[cfg.name]
    json.dumps({"graphs": chip_smoke.GRAPH_REPORT})
    for mode, row in report.items():
        assert row["logits_bitwise"] and not row["caches_differ"], mode
        assert row["tokens_equal"] == row["requests"] == chip_smoke.REQUESTS
        assert row["eager_passes"] == row["programs"] == (1 if mode == "space_time" else 4)
        assert row["replays"] == row["decode_passes"] - row["eager_passes"]
        assert not row["stale_inputs_control"]["logits_bitwise"]
        assert row["state_control"]["kind"] == "decoded twice"
        assert {"ssm", "conv_x"} <= set(row["state_control"]["caches_differ"])
        # the piece route: prefills bitwise equal to the same pieces run
        # eagerly, and both of its controls caught
        pre = row["prefill"]
        assert pre["route"] == "pieces" and pre["first_tokens_equal"] and not pre["caches_differ"]
        assert pre["stale_start_control"]["caught"]
        unreset = pre["recurrent_state_left_unreset_control"]
        assert {"ssm", "conv_x"} <= set(unreset["caches_differ"])
        assert pre["captures"] == pre["programs"] == 4 * 8  # sizes 128, 64, ..., 1
    assert set(chip_smoke.PREFILL_REPORT[cfg.name]) == {"space_time", "time_only"}
