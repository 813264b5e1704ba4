"""The port's serving engine against the JAX package's.

Three stablelm smoke tenants (float32, weights converted from the JAX
init), two slots each, nine requests of one prompt length (so JAX compiles
once): greedy tokens must be identical per request, in both space_time and
time_only mode. Greedy is an argmax over logits that agree to float32
rounding, so exact equality is the right check. The same holds for three
rwkv6-1.6b smoke tenants (recurrent caches: wkv state and token shifts),
with a data-dependent decay (``w_lora_b`` made non-zero in both), whole and
with chunked prefill, for three paligemma-3b smoke tenants (one kv head,
tied and scaled embeddings; text only, as the reference's engine serves it),
and for three granite-moe-1b-a400m (MoE) and three zamba2-7b (Mamba2 caches
beside k/v caches, one shared attention block applied twice) smoke tenants,
whole and with chunked prefill (the reference's chunks too: MoE capacity is
per chunk).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import get_config as jget_config  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402
from repro.serving import EngineConfig as JEngineConfig  # noqa: E402
from repro.serving import InferenceRequest as JRequest  # noqa: E402
from repro.serving import MultiTenantEngine as JEngine  # noqa: E402
from repro.serving.sampling import apply_top_k as japply_top_k  # noqa: E402
from repro.serving.sampling import apply_top_p as japply_top_p  # noqa: E402

from repro_torch.config import BlockKind, get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import params_from_jax_numpy  # noqa: E402
from repro_torch.serving import (  # noqa: E402
    EngineConfig,
    InferenceRequest,
    MultiTenantEngine,
    SamplingParams,
    sample,
)
from repro_torch.serving.sampling import apply_top_k, apply_top_p  # noqa: E402

R, SLOTS, CACHE_LEN, PROMPT_LEN, NEW = 3, 2, 32, 6, 5


def _with_live_decay(tree, seed):
    """JAX params (numpy leaves) with a random w_lora_b in every RWKV layer."""
    rng = np.random.RandomState(seed)

    def fix(path, a):
        if getattr(path[-1], "key", None) == "w_lora_b":
            return (rng.standard_normal(a.shape) * 0.1).astype(a.dtype)
        return a

    return jax.tree_util.tree_map_with_path(fix, tree)


@pytest.fixture(scope="module")
def rwkv_tenants():
    jcfg = jsmoke(jget_config("rwkv6-1.6b"))
    cfg = smoke_variant(get_config("rwkv6-1.6b"))
    jm = jbuild_model(jcfg)
    key = jax.random.PRNGKey(1)
    trees = [_with_live_decay(jax.tree.map(np.asarray, jm.init(jax.random.fold_in(key, t))), t)
             for t in range(R)]
    jparams = [jax.tree.map(jnp.asarray, t) for t in trees]
    tparams = [params_from_jax_numpy(cfg, t, device="cpu") for t in trees]
    return cfg, jm, jparams, build_model(cfg, device="cpu"), tparams


def _serve_jax(jm, jparams, prompts, **cfg):
    jeng = JEngine(jm, jparams, JEngineConfig(
        num_tenants=R, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, **cfg))
    for t, p in prompts:
        jeng.submit(JRequest(tenant_id=t, prompt=p, max_new_tokens=NEW))
    jeng.run_until_drained()
    return jeng


def _tenants(arch, num_layers=2):
    jcfg = jsmoke(jget_config(arch), num_layers=num_layers)
    cfg = smoke_variant(get_config(arch), num_layers=num_layers)
    jm = jbuild_model(jcfg)
    key = jax.random.PRNGKey(0)
    jparams = [jm.init(jax.random.fold_in(key, t)) for t in range(R)]
    tparams = [params_from_jax_numpy(cfg, jax.tree.map(np.asarray, p), device="cpu")
               for p in jparams]
    return cfg, jm, jparams, build_model(cfg, device="cpu"), tparams


@pytest.fixture(scope="module")
def tenants():
    return _tenants("stablelm-1.6b")


@pytest.fixture(scope="module")
def pali_tenants():
    """paligemma-3b's smoke variant: tied and scaled embeddings, one kv head
    for four query heads, a frontend_proj the engine leaves unused (it
    serves text only, as the reference's engine does)."""
    return _tenants("paligemma-3b")


@pytest.fixture(scope="module")
def new_arch_tenants():
    """granite-moe's smoke variant (every layer attention + MoE) and
    zamba2's at 4 layers (mamba2, shared, mamba2, shared)."""
    return {"granite-moe-1b-a400m": _tenants("granite-moe-1b-a400m"),
            "zamba2-7b": _tenants("zamba2-7b", num_layers=4)}


def _prompts(seed, n=9):
    rng = np.random.RandomState(seed)
    return [(i % R, [int(x) for x in rng.randint(1, 1024, size=PROMPT_LEN)]) for i in range(n)]


def _serve_port(model, tparams, prompts, **cfg):
    eng = MultiTenantEngine(model, tparams, EngineConfig(
        num_tenants=R, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, **cfg))
    for t, p in prompts:
        eng.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=NEW))
    eng.run_until_drained()
    return eng


def _tokens(eng):
    return sorted((r.tenant_id, tuple(r.prompt), tuple(r.generated)) for r in eng.finished)


@pytest.mark.parametrize("mode", ["space_time", "time_only"])
def test_greedy_tokens_match_jax_engine(tenants, mode):
    cfg, jm, jparams, model, tparams = tenants
    prompts = _prompts(0)
    jeng = JEngine(jm, jparams, JEngineConfig(
        num_tenants=R, slots_per_tenant=SLOTS, cache_len=CACHE_LEN, mode=mode))
    for t, p in prompts:
        jeng.submit(JRequest(tenant_id=t, prompt=p, max_new_tokens=NEW))
    jeng.run_until_drained()
    ops.reset_counters()
    eng = _serve_port(model, tparams, prompts, mode=mode)
    assert len(eng.finished) == 9
    assert _tokens(eng) == _tokens(jeng)
    assert sorted(eng.report()) == sorted(k for k in jeng.report() if k != "cache_hit_rate")
    # the engine's dispatches go through the scheduler the way the JAX
    # engine's do: same number of merged dispatches and steps
    assert eng.report()["scheduler_dispatches"] == jeng.report()["scheduler_dispatches"]
    assert eng.steps == jeng.steps
    # on the CPU every attention call took the plain version
    assert ops.COUNTERS["decode_attention"].plain_calls > 0
    assert ops.COUNTERS["flash_attention"].plain_calls == 9 * cfg.num_layers  # one per prefill layer


@pytest.mark.parametrize("mode", ["space_time", "time_only"])
def test_paligemma_greedy_tokens_match_jax_engine(pali_tenants, mode):
    cfg, jm, jparams, model, tparams = pali_tenants
    assert cfg.num_prefix_embeddings and "frontend_proj" in tparams[0]
    prompts = _prompts(12)
    jeng = _serve_jax(jm, jparams, prompts, mode=mode)
    ops.reset_counters()
    eng = _serve_port(model, tparams, prompts, mode=mode)
    assert len(eng.finished) == 9
    assert _tokens(eng) == _tokens(jeng)
    assert eng.report()["scheduler_dispatches"] == jeng.report()["scheduler_dispatches"]
    assert eng.steps == jeng.steps
    assert ops.COUNTERS["flash_attention"].plain_calls == 9 * cfg.num_layers


@pytest.mark.parametrize("mode", ["space_time", "time_only"])
def test_rwkv_greedy_tokens_match_jax_engine(rwkv_tenants, mode):
    """Each prefill is one WKV6 scan per layer (its plain version on the
    CPU), from a zero state in a recycled slot too (9 requests, 6 slots)."""
    cfg, jm, jparams, model, tparams = rwkv_tenants
    prompts = _prompts(10)
    jeng = _serve_jax(jm, jparams, prompts, mode=mode)
    ops.reset_counters()
    eng = _serve_port(model, tparams, prompts, mode=mode)
    assert len(eng.finished) == 9
    assert _tokens(eng) == _tokens(jeng)
    assert eng.report()["scheduler_dispatches"] == jeng.report()["scheduler_dispatches"]
    assert eng.steps == jeng.steps
    assert ops.COUNTERS["wkv6_scan"].plain_calls == 9 * cfg.num_layers
    assert all(c.launches == 0 for c in ops.COUNTERS.values())
    assert sorted(eng.caches) == ["shift_cm", "shift_tm", "wkv"]


def test_rwkv_chunked_prefill_engine_matches_jax(rwkv_tenants):
    """Prompts of 6 prefilled in chunks of 4 (4 + 2, the second chunk's
    scan starting from the first's state) give the JAX engine's tokens."""
    cfg, jm, jparams, model, tparams = rwkv_tenants
    prompts = _prompts(11, n=6)
    jeng = _serve_jax(jm, jparams, prompts)
    ops.reset_counters()
    chunked = _serve_port(model, tparams, prompts, prefill_chunk=4)
    assert _tokens(chunked) == _tokens(jeng)
    assert ops.COUNTERS["wkv6_scan"].plain_calls == 2 * 6 * cfg.num_layers


def _attention_layers(cfg):
    return sum(k != BlockKind.MAMBA2 for k in cfg.layer_pattern)


@pytest.mark.parametrize("mode", ["space_time", "time_only"])
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b"])
def test_moe_and_hybrid_greedy_tokens_match_jax_engine(new_arch_tenants, arch, mode):
    """Nine requests over six slots (recycled slots start from the state a
    fresh prefill writes): the JAX engine's tokens, one prefill attention
    call per attention layer (zamba2: its 2 shared positions of 4)."""
    cfg, jm, jparams, model, tparams = new_arch_tenants[arch]
    prompts = _prompts(13)
    jeng = _serve_jax(jm, jparams, prompts, mode=mode)
    ops.reset_counters()
    eng = _serve_port(model, tparams, prompts, mode=mode)
    assert len(eng.finished) == 9
    assert _tokens(eng) == _tokens(jeng)
    assert eng.report()["scheduler_dispatches"] == jeng.report()["scheduler_dispatches"]
    assert eng.steps == jeng.steps
    assert ops.COUNTERS["flash_attention"].plain_calls == 9 * _attention_layers(cfg)
    if arch == "zamba2-7b":
        assert sorted(eng.caches) == ["conv_B", "conv_C", "conv_x", "k", "ssm", "v"]
        assert "shared_attn" in eng.stacked_params and eng.stacked_params["layers"][1] == {}


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "zamba2-7b"])
def test_moe_and_hybrid_chunked_prefill_engine_matches_jax(new_arch_tenants, arch):
    """Prompts of 6 prefilled in chunks of 4 (4 + 2) in both engines: the
    second chunk continues the conv tails and SSM state, and its MoE
    capacity is its own chunk's, as in the reference."""
    cfg, jm, jparams, model, tparams = new_arch_tenants[arch]
    prompts = _prompts(14, n=6)
    jeng = _serve_jax(jm, jparams, prompts, prefill_chunk=4)
    ops.reset_counters()
    chunked = _serve_port(model, tparams, prompts, prefill_chunk=4)
    assert _tokens(chunked) == _tokens(jeng)
    assert ops.COUNTERS["flash_attention"].plain_calls == 2 * 6 * _attention_layers(cfg)


def test_space_time_merges_decode_time_only_does_not(tenants):
    cfg, jm, jparams, model, tparams = tenants
    prompts = _prompts(1, n=3)
    st = _serve_port(model, tparams, prompts, mode="space_time")
    to = _serve_port(model, tparams, prompts, mode="time_only")
    assert _tokens(st) == _tokens(to)
    # one merged decode dispatch per step vs one per active tenant per step
    decode_steps = st.steps
    assert st.scheduler.stats.dispatches == decode_steps + 1  # + the merged prefill batch
    assert to.scheduler.stats.dispatches == R * decode_steps + 1


def test_chunked_prefill_engine_matches_whole(tenants):
    cfg, jm, jparams, model, tparams = tenants
    prompts = _prompts(2, n=3)
    whole = _serve_port(model, tparams, prompts)
    chunked = _serve_port(model, tparams, prompts, prefill_chunk=4)
    assert _tokens(chunked) == _tokens(whole)


def test_slot_recycling(tenants):
    cfg, jm, jparams, model, tparams = tenants
    eng = MultiTenantEngine(model, tparams[:1], EngineConfig(
        num_tenants=1, slots_per_tenant=1, cache_len=CACHE_LEN))
    rng = np.random.RandomState(3)
    for _ in range(3):
        eng.submit(InferenceRequest(tenant_id=0, prompt=list(rng.randint(1, 1024, size=4)),
                                    max_new_tokens=3))
    eng.run_until_drained()
    assert len(eng.finished) == 3
    assert eng.slots.utilization() == 0.0
    # a recycled slot serves a fresh request exactly as a fresh engine would
    fresh = MultiTenantEngine(model, tparams[:1], EngineConfig(
        num_tenants=1, slots_per_tenant=1, cache_len=CACHE_LEN))
    fresh.submit(InferenceRequest(tenant_id=0, prompt=eng.finished[-1].prompt,
                                  max_new_tokens=3))
    fresh.run_until_drained()
    assert fresh.finished[0].generated == eng.finished[-1].generated


def test_report_metrics(tenants):
    cfg, jm, jparams, model, tparams = tenants
    eng = _serve_port(model, tparams, _prompts(4, n=2))
    rep = eng.report()
    assert rep["finished"] == 2.0
    assert rep["decode_tokens"] >= 4.0
    for key in ("req_mean_latency_s", "p50_s", "p95_s", "spread", "prefill_p50_s",
                "slot_utilization", "scheduler_dispatches"):
        assert key in rep


def test_stacked_params_engine_matches_list(tenants):
    cfg, jm, jparams, model, tparams = tenants
    prompts = _prompts(5, n=3)
    from_list = _serve_port(model, tparams, prompts)
    stacked = MultiTenantEngine(model, stacked_params=from_list.stacked_params,
                                config=EngineConfig(num_tenants=R, slots_per_tenant=SLOTS,
                                                    cache_len=CACHE_LEN))
    for t, p in prompts:
        stacked.submit(InferenceRequest(tenant_id=t, prompt=p, max_new_tokens=NEW))
    stacked.run_until_drained()
    assert _tokens(stacked) == _tokens(from_list)
    with pytest.raises(ValueError):
        MultiTenantEngine(model, tparams, EngineConfig(num_tenants=R),
                          stacked_params=from_list.stacked_params)


@pytest.mark.parametrize("k,p", [(5, 1.0), (0, 0.8), (7, 0.5)])
def test_top_k_top_p_masks_match_jax(k, p):
    logits = np.random.RandomState(6).standard_normal((3, 50)).astype(np.float32)
    got = apply_top_p(apply_top_k(torch.from_numpy(logits), k), p).numpy()
    want = np.asarray(japply_top_p(japply_top_k(jnp.asarray(logits), k), p))
    np.testing.assert_array_equal(got, want)


def test_seeded_sampling_is_deterministic():
    logits = torch.from_numpy(np.random.RandomState(7).standard_normal((2, 3, 40)).astype(np.float32))
    params = SamplingParams(temperature=0.8, top_k=10, top_p=0.9)
    draws = [sample(logits, params, torch.Generator().manual_seed(11)) for _ in range(2)]
    assert torch.equal(draws[0], draws[1]) and draws[0].shape == (2, 3)
    kept = apply_top_k(logits, 10) > -1e29
    assert bool(kept.gather(-1, draws[0].long()[..., None]).all())
    assert torch.equal(sample(logits, SamplingParams()), logits.argmax(-1).int())
