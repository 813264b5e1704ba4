"""The engine's prefill programs (the piece route) on the CPU.

CUDA graphs exist only on the card, where ``chip_smoke.py`` holds the
captured prefills against the same pieces run eagerly. Here, at smoke
width in float32:

- the piece rule (``prefill_pieces``, ``piece_sizes``) at every prompt
  length below the cache, and the architecture rule (``takes_pieces``,
  ``prefill_route``) over every registered architecture;
- K4's device offset: the plain version with a 0-dim tensor ``q_offset``
  equals the host-int path; the wrapper hands the kernel the tensor's
  address and never reads its value, and refuses a tensor it cannot take
  before any launch;
- a tensor ``start`` through ``forward_prefill`` and
  ``attn_prefill_continue``, reading nothing on the host, against the
  reference's ``jax.jit`` continuation with a traced start and against its
  whole-prompt prefill, on the logits and on every cache the model keeps
  (stablelm-, rwkv6-, zamba2- and paligemma-like configs): rtol = atol =
  1e-4, the float32 rounding of a few layers summed in another order, as
  the port's other model tests;
- the engine on the piece route through a stand-in for ``GraphShare`` (the
  recording one of ``test_torch_graphs.py``: its capture runs the step, its
  replay runs it again with no Python-side count): the JAX engine's greedy
  tokens, each (tenant, size) captured once at build and nothing while
  serving, each replay counting the graph's plain calls, every piece read
  from the programs' static buffers and the one scratch cache, never
  rebound; and the same pieces run eagerly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

import test_torch_serving as ts  # noqa: E402
from test_torch_graphs import CpuShare  # noqa: E402
from test_torch_serving import rwkv_tenants, tenants  # noqa: E402,F401  (fixtures)

from repro_torch.config import BlockKind, get_config, list_configs  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.models.convert import caches_to_jax_numpy  # noqa: E402
from repro_torch.serving import EngineConfig, InferenceRequest, MultiTenantEngine  # noqa: E402
from repro_torch.serving import engine as engine_mod  # noqa: E402
from repro_torch.serving import graphs  # noqa: E402

RTOL = ATOL = 1e-4
PIECE_ARCHS = ("stablelm-1.6b", "rwkv6-1.6b", "paligemma-3b", "zamba2-7b", "musicgen-large",
               "qwen2-7b", "granite-3-8b")
WHOLE_ARCHS = ("granite-moe-1b-a400m", "llama4-maverick-400b-a17b", "gemma3-27b")


# ------------------------------------------------------------------ the rules
@pytest.mark.parametrize("cache_len,chunk", [
    (2048, 0), (2048, 512), (2048, 100), (256, 0), (256, 64), (256, 7), (48, 0), (33, 0),
    (32, 4), (32, 31)])
def test_pieces_sum_to_the_prompt_from_a_fixed_set(cache_len, chunk):
    """Every S from 1 to cache_len - 1: the pieces sum to S, each lies in
    ``piece_sizes``, longest first, and there are at most floor(S / top) +
    log2(top) of them, top the longest size (``chunk``, or the largest
    power of two below cache_len)."""
    sizes = engine_mod.piece_sizes(chunk, cache_len)
    top = sizes[0]
    assert top == (chunk if 0 < chunk < cache_len else 1 << (cache_len - 1).bit_length() - 1)
    assert list(sizes) == sorted(set(sizes), reverse=True) and top < cache_len
    assert len(sizes) <= 1 + int(np.log2(cache_len))
    for S in range(1, cache_len):
        got = engine_mod.prefill_pieces(S, chunk, cache_len)
        assert sum(got) == S and set(got) <= set(sizes), (S, got)
        assert got == sorted(got, reverse=True)
        assert len(got) <= S // top + np.log2(top), (S, got)


def test_pieces_of_the_median_prompt():
    assert engine_mod.prefill_pieces(742, 0, 2048) == [512, 128, 64, 32, 4, 2]
    assert engine_mod.prefill_pieces(2047, 0, 2048) == [1024, 512, 256, 128, 64, 32, 16, 8, 4,
                                                         2, 1]
    assert engine_mod.prefill_pieces(1300, 512, 2048) == [512, 512, 256, 16, 4]
    assert engine_mod.piece_sizes(0, 2048) == (1024, 512, 256, 128, 64, 32, 16, 8, 4, 2, 1)


@pytest.mark.parametrize("arch", sorted(list_configs()))
def test_architecture_rule(arch):
    """Pieces for every architecture without a ring cache or an MoE FFN, by
    the rule only on a graphed engine; asking for pieces of the others
    raises, and asking for whole prompts always holds."""
    cfg = get_config(arch)
    ring = any(cfg.attention_kind_at(i).value == "sliding" and cfg.sliding_window > 0
               for i in range(cfg.num_layers))
    moe = BlockKind.ATTN_MOE in cfg.layer_pattern
    assert engine_mod.takes_pieces(cfg) == (not ring and not moe)
    assert (arch in PIECE_ARCHS) == engine_mod.takes_pieces(cfg)
    assert (arch in WHOLE_ARCHS) == (not engine_mod.takes_pieces(cfg))
    assert engine_mod.prefill_route(cfg, graphed=False) == "whole"
    assert engine_mod.prefill_route(cfg, graphed=True) == (
        "pieces" if engine_mod.takes_pieces(cfg) else "whole")
    assert engine_mod.prefill_route(cfg, graphed=True, pieces=False) == "whole"
    if engine_mod.takes_pieces(cfg):
        assert engine_mod.prefill_route(cfg, graphed=False, pieces=True) == "pieces"
    else:
        with pytest.raises(ValueError, match="prefills whole prompts"):
            engine_mod.prefill_route(cfg, graphed=True, pieces=True)


def test_engines_of_moe_and_ring_architectures_keep_whole_prompts(monkeypatch):
    """granite-moe (MoE capacity) on a graphed engine: the whole-prompt
    route, no scratch cache and no prefill program; pieces=True raises."""
    import dataclasses

    from repro_torch.config import smoke_variant
    from repro_torch.models import build_model

    cfg = dataclasses.replace(smoke_variant(get_config("granite-moe-1b-a400m")), num_layers=1,
                              block_pattern=(BlockKind.ATTN_MOE,))
    model = build_model(cfg, device="cpu")
    stacked = model.init_stacked([torch.Generator().manual_seed(0)])
    monkeypatch.setattr(graphs, "use_graphs", lambda device, g=None: True)
    monkeypatch.setattr(graphs, "GraphShare", lambda device: CpuShare({}))
    eng = MultiTenantEngine(model, stacked_params=stacked,
                            config=EngineConfig(num_tenants=1, cache_len=16))
    assert eng.prefill_route == "whole" and eng.scratch is None
    assert eng.programs.prefill is None and "prefill_programs" not in eng.programs.stats()
    with pytest.raises(ValueError, match="prefills whole prompts"):
        MultiTenantEngine(model, stacked_params=stacked, pieces=True,
                          config=EngineConfig(num_tenants=1, cache_len=16))


# ------------------------------------------------------- K4's device offset
@pytest.mark.parametrize("chunked", [False, True], ids=["dense", "chunked"])
@pytest.mark.parametrize("window", [0, 5])
@pytest.mark.parametrize("q_offset", [0, 3, 17, 24])
def test_plain_attention_takes_a_tensor_offset(q_offset, window, chunked):
    """``ref.attention`` (and the chunked form the plain op takes past 2048
    keys) with a 0-dim int64 ``q_offset`` equals the host-int path bit for
    bit: the same mask from the same positions. Offsets 0, mid-tile, and
    ``start + n == Skv``."""
    rng = np.random.RandomState(q_offset + window)
    B, Hq, Hkv, Sq, Skv, D = 1, 4, 2, 8, 32, 16
    q, k, v = (torch.from_numpy(rng.standard_normal(s).astype(np.float32))
               for s in ((B, Hq, Sq, D), (B, Hkv, Skv, D), (B, Hkv, Skv, D)))
    fn = (lambda *a, **kw: ref.attention_chunked(*a, kv_chunk=8, **kw)) if chunked \
        else ref.attention
    want = fn(q, k, v, causal=True, window=window, q_offset=q_offset)
    got = fn(q, k, v, causal=True, window=window, q_offset=torch.tensor(q_offset))
    assert torch.equal(got, want)
    other = fn(q, k, v, causal=True, window=window, q_offset=torch.tensor(q_offset + 1))
    assert not torch.equal(other, want)  # the offset is read: off by one differs


class _Recorder:
    """A stand-in K4 library: records the launch's arguments, launches
    nothing and reports success."""

    def __init__(self):
        self.calls = []

    def repro_flash_attention(self, *args):
        self.calls.append(args)
        return 0


@pytest.fixture
def recorded(monkeypatch):
    lib = _Recorder()
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
    return lib


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _no_host_reads(monkeypatch):
    """Any read of a tensor's value on the host raises (a sync on the card,
    and an error while a graph is captured)."""
    def boom(self, *a, **k):
        raise AssertionError("a tensor was read on the host")
    for name in ("item", "__int__", "__index__", "tolist", "__float__"):
        monkeypatch.setattr(torch.Tensor, name, boom)


@pytest.mark.parametrize("D,dtype", [(64, torch.bfloat16), (112, torch.bfloat16),
                                     (64, torch.float32)])
def test_k4_wrapper_passes_the_offset_by_address(recorded, monkeypatch, D, dtype):
    """A tensor offset goes to the kernel as a device address, with the host
    offset 0 beside it, on either variant, and its value is never read; a
    host offset goes as before, with a null address."""
    q = torch.zeros((1, 4, 8, D), dtype=dtype)
    k = torch.zeros((1, 2, 32, D), dtype=dtype)
    start = torch.tensor(12)
    fa.flash_attention(q, k, k.clone(), q_offset=7)
    with monkeypatch.context() as m:
        _no_host_reads(m)
        fa.flash_attention(q, k, k.clone(), q_offset=start)
    (host, dev) = recorded.calls
    # q, k, v, out, lse, q_offset_dev, B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset, ...
    assert host[5] is None and host[14] == 7
    assert dev[5] == start.data_ptr() and dev[14] == 0
    assert dev[16] == _build.VARIANT_CODES[fa.variant(dtype, D)]
    assert len(_build.SIGNATURES["flash_attention"][0]) == len(dev)


@pytest.mark.parametrize("bad", ["int32", "two", "float"])
def test_k4_wrapper_refuses_an_offset_it_cannot_read(recorded, bad):
    q = torch.zeros((1, 4, 8, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 2, 32, 64), dtype=torch.bfloat16)
    offset = {"int32": torch.tensor(3, dtype=torch.int32), "two": torch.tensor([3, 4]),
              "float": torch.tensor(3.0)}[bad]
    with pytest.raises(ValueError, match="tensor q_offset must be one int64"):
        fa.flash_attention(q, k, k.clone(), q_offset=offset)
    assert not recorded.calls


def test_k4_backward_refuses_a_tensor_offset():
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="host q_offset"):
        fa.check_bwd(q, q, q_offset=torch.tensor(0))


# ------------------------------------ a tensor start against the reference
ARCH_LAYERS = {"stablelm-1.6b": 2, "rwkv6-1.6b": 2, "paligemma-3b": 2, "zamba2-7b": 4}
PROMPT = 13


@pytest.fixture(scope="module")
def models():
    """Tenant 0 of each smoke model (rwkv6 with a data-dependent decay)."""
    out = {}
    for arch, n in ARCH_LAYERS.items():
        if arch == "rwkv6-1.6b":
            continue
        cfg, jm, jparams, model, tparams = ts._tenants(arch, num_layers=n)
        out[arch] = (cfg, jm, jparams[0], model, tparams[0])
    return out


def _model(models, rwkv_tenants, arch):  # noqa: F811
    if arch == "rwkv6-1.6b":
        cfg, jm, jparams, model, tparams = rwkv_tenants
        return cfg, jm, jparams[0], model, tparams[0]
    return models[arch]


def _assert_caches(cfg, got, want):
    """Every cache leaf of the port's (its JAX layout) against the JAX tree."""
    got = caches_to_jax_numpy(cfg, got)
    leaves = jax.tree_util.tree_leaves_with_path(jax.tree.map(np.asarray, want))
    assert leaves
    for path, leaf in leaves:
        mine = got
        for p in path:
            mine = mine[getattr(p, "key", getattr(p, "idx", None))]
        np.testing.assert_allclose(mine, leaf, rtol=RTOL, atol=ATOL, err_msg=str(path))


@pytest.mark.parametrize("arch", list(ARCH_LAYERS))
def test_tensor_start_matches_the_jitted_continuation(models, rwkv_tenants, arch,  # noqa: F811
                                                      monkeypatch):
    """A 13-token prompt as the pieces 8, 4, 1, each a ``forward_prefill``
    continuation with ``start`` a 0-dim int64 tensor into one zeroed cache
    (nothing read on the host): after each piece the logits and every cache
    equal the reference's ``jax.jit`` continuation with a traced int32
    start from its zeroed caches; after the last, the reference's
    whole-prompt prefill too (K/V past the prompt are zero in both)."""
    cfg, jm, jp, tm, tp = _model(models, rwkv_tenants, arch)
    cache_len = ts.CACHE_LEN
    toks = np.random.RandomState(9).randint(1, cfg.vocab_size, size=(1, PROMPT)).astype(np.int32)
    pieces = engine_mod.prefill_pieces(PROMPT, 0, cache_len)
    assert pieces == [8, 4, 1]
    cont = jax.jit(lambda p, t, c, s: jm.forward_prefill(p, t, cache_len, caches=c, start=s))
    jc = jm.init_caches(1, cache_len)
    scratch = tm.init_caches(1, cache_len)
    t = torch.from_numpy(toks).long()
    start = torch.zeros((), dtype=torch.int64)
    pos = 0
    with torch.no_grad():
        for n in pieces:
            jl, jc = cont(jp, jnp.asarray(toks[:, pos:pos + n]), jc, jnp.int32(pos))
            start.fill_(pos)
            with monkeypatch.context() as m:
                _no_host_reads(m)
                tl, back = tm.forward_prefill(tp, t[:, pos:pos + n], cache_len, caches=scratch,
                                              start=start)
            assert back is scratch
            np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=RTOL, atol=ATOL)
            _assert_caches(cfg, scratch, jc)
            pos += n
    wl, wc = jm.forward_prefill(jp, jnp.asarray(toks), cache_len)
    np.testing.assert_allclose(tl.numpy(), np.asarray(wl), rtol=RTOL, atol=ATOL)
    _assert_caches(cfg, scratch, wc)


def test_tensor_start_equals_a_host_start(models):
    """``attn_prefill_continue`` with a tensor start writes K/V through a
    device index and gives the host-int path's output and cache bit for
    bit; ``forward_prefill`` likewise."""
    cfg, jm, jp, tm, tp = models["stablelm-1.6b"]
    t = torch.from_numpy(np.random.RandomState(4).randint(1, cfg.vocab_size, size=(1, 11))).long()
    with torch.no_grad():
        _, host = tm.forward_prefill(tp, t[:, :5], ts.CACHE_LEN)
        dev = {k: [c.clone() for c in v] for k, v in host.items()}
        lh, host = tm.forward_prefill(tp, t[:, 5:], ts.CACHE_LEN, caches=host, start=5)
        ld, dev = tm.forward_prefill(tp, t[:, 5:], ts.CACHE_LEN, caches=dev,
                                     start=torch.tensor(5))
    assert torch.equal(lh, ld)
    for name in host:
        for a, b in zip(host[name], dev[name]):
            assert torch.equal(a, b), name


# -------------------------------------------- the engine on the piece route
class PieceShare(CpuShare):
    """``CpuShare`` that counts captures by the step's tokens buffer."""

    def __init__(self):
        super().__init__({})
        self.captured = []

    def capture(self, step, tokens, second):
        self.captured.append(tokens.data_ptr())
        return super().capture(step, tokens, second)


@pytest.fixture
def counters():
    saved = {k: c.copy() for k, c in ops.COUNTERS.items()}
    ops.reset_counters()
    yield ops.COUNTERS
    for k, c in ops.COUNTERS.items():
        c.reset()
        c.add(saved[k])


def _graph_route(monkeypatch, shares):
    """Engines built from here run the graph route on the CPU with a
    ``PieceShare`` each (collected in ``shares``); the decode captures
    restore the stacked caches once the engine exists."""
    def make(device):
        shares.append(PieceShare())
        return shares[-1]
    monkeypatch.setattr(graphs, "use_graphs", lambda device, g=None: g is not False)
    monkeypatch.setattr(graphs, "GraphShare", make)


def _watch_prefill(model, seen):
    fn = model.forward_prefill

    def watched(params, tokens, cache_len, caches=None, start=None, **kw):
        seen.append((tokens.data_ptr(), tokens.shape[1], id(caches), start))
        return fn(params, tokens, cache_len, caches=caches, start=start, **kw)
    model.forward_prefill = watched


@pytest.mark.parametrize("mode", ["space_time", "time_only"])
@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b", "zamba2-7b"])
def test_graphed_piece_route_matches_jax_engine(request, monkeypatch, counters, arch, mode):
    """Nine prompts of 6 (pieces 4 + 2) over six slots: the JAX engine's
    greedy tokens; every (tenant, size) captured once at build, one warm-up
    a size, no capture while serving, one replay a piece, each replay
    counting the graph's plain calls; every piece ran on a program's static
    token buffer, the engine's start buffer and the one scratch cache,
    whose tensors never moved."""
    cfg, jm, jparams, model, tparams = {
        "stablelm-1.6b": lambda: request.getfixturevalue("tenants"),
        "rwkv6-1.6b": lambda: request.getfixturevalue("rwkv_tenants"),
        "zamba2-7b": lambda: ts._tenants("zamba2-7b", num_layers=4)}[arch]()
    prompts = ts._prompts(21)
    jeng = ts._serve_jax(jm, jparams, prompts, mode=mode)
    shares = []
    _graph_route(monkeypatch, shares)
    eng = MultiTenantEngine(model, tparams, EngineConfig(
        num_tenants=ts.R, slots_per_tenant=ts.SLOTS, cache_len=ts.CACHE_LEN, mode=mode))
    (share,) = shares
    share.caches = eng.caches  # the decode captures put the stacked caches back
    sizes = engine_mod.piece_sizes(0, ts.CACHE_LEN)
    prefill = eng.programs.prefill
    assert eng.prefill_route == "pieces" and prefill.sizes == sizes
    st = eng.programs.stats()
    assert st["prefill_programs"] == st["prefill_captures"] == ts.R * len(sizes)
    assert st["prefill_warm_ups"] == len(sizes) and st["prefill_replays"] == 0
    assert sorted(share.captured) == sorted(p.tokens.data_ptr()
                                            for p in prefill.programs.values())
    assert all(float(c.abs().sum()) == 0 for v in eng.scratch.values() for c in v)
    ptrs = {k: [c.data_ptr() for c in v] for k, v in eng.scratch.items()}
    ops.reset_counters()
    seen = []
    _watch_prefill(model, seen)
    try:
        for t, p in prompts:
            eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=ts.NEW))
        eng.run_until_drained()
    finally:
        del model.forward_prefill
    assert ts._tokens(eng) == ts._tokens(jeng)
    st = eng.programs.stats()
    n_pieces = sum(len(engine_mod.prefill_pieces(len(p), 0, ts.CACHE_LEN)) for _, p in prompts)
    assert n_pieces == 2 * len(prompts)
    assert st["prefill_captures"] == ts.R * len(sizes) and st["prefill_replays"] == n_pieces
    assert st["prefill_eager_passes"] == 0 and len(share.captured) == ts.R * len(sizes) + (
        st["captures"])
    assert {k: [c.data_ptr() for c in v] for k, v in eng.scratch.items()} == ptrs
    tokens = {p.tokens.data_ptr() for p in prefill.programs.values()}
    assert len(seen) == n_pieces  # the stand-in's replays run the step
    for ptr, n, caches, start in seen:
        assert ptr in tokens and caches == id(eng.scratch) and start is eng.start
    if arch == "rwkv6-1.6b":
        per_piece = cfg.num_layers  # one scan a layer in float32
        assert counters["wkv6_scan"].plain_calls == per_piece * n_pieces
    else:
        n_attn = sum(k != BlockKind.MAMBA2 for k in cfg.layer_pattern)
        assert counters["flash_attention"].plain_calls == n_attn * n_pieces
    assert all(c.launches == 0 for c in counters.values())


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "rwkv6-1.6b"])
def test_eager_pieces_match_graphed_pieces(request, monkeypatch, arch):
    """``pieces=True`` on an eager engine runs the same pieces with no
    capture: tokens and every installed cache equal the graph route's, and
    a recycled slot starts from the zeroed recurrent state."""
    cfg, jm, jparams, model, tparams = request.getfixturevalue(
        {"stablelm-1.6b": "tenants", "rwkv6-1.6b": "rwkv_tenants"}[arch])
    rng = np.random.RandomState(5)
    prompts = [(i % ts.R, [int(x) for x in rng.randint(1, 1024, size=int(n))])
               for i, n in enumerate(rng.randint(1, ts.CACHE_LEN - ts.NEW, size=9))]
    eager = MultiTenantEngine(model, tparams, EngineConfig(
        num_tenants=ts.R, slots_per_tenant=ts.SLOTS, cache_len=ts.CACHE_LEN), pieces=True)
    shares = []
    _graph_route(monkeypatch, shares)
    graphed = MultiTenantEngine(model, tparams, EngineConfig(
        num_tenants=ts.R, slots_per_tenant=ts.SLOTS, cache_len=ts.CACHE_LEN))
    shares[0].caches = graphed.caches
    assert eager.prefill_route == graphed.prefill_route == "pieces"
    for eng in (eager, graphed):
        for t, p in prompts:
            eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=ts.NEW))
    steps = 0
    with torch.no_grad():  # every step, recycled slots' prefills included
        while eager.queue or eager.active:
            eager.step()
            graphed.step()
            steps += 1
            for name in eager.caches:
                for a, b in zip(eager.caches[name], graphed.caches[name]):
                    assert torch.equal(a, b), name
    assert steps > ts.NEW and not graphed.queue and not graphed.active
    assert ts._tokens(eager) == ts._tokens(graphed)
    se, sg = eager.programs.stats(), graphed.programs.stats()
    assert se["prefill_captures"] == 0 and se["prefill_replays"] == 0
    assert se["prefill_eager_passes"] == sg["prefill_replays"] > 0
