"""The port's mixture-of-experts FFN against the JAX package's ``moe_forward``.

Seeded numpy weights and tokens go through both, in float32; outputs and
the load-balance loss must agree to float32 rounding (rtol/atol 1e-4, as
``test_torch_models.py``). The port takes a leading tenant axis (weights
(R, E, d, f), tokens (R, B, S, d)); the JAX function takes one tenant's
(B, S, d), so each tenant is compared with its own call. Cases: a prefill
length at which the per-sequence capacity drops (token, expert) pairs
(asserted, so the capacity path really runs), a shared expert, an ungated
MLP, and a decode step (S = 1, where nothing is dropped).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import MoEConfig as JMoEConfig  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402

from repro_torch.config import MoEConfig, get_config, smoke_variant  # noqa: E402
from repro_torch.models import moe  # noqa: E402

RTOL = ATOL = 1e-4
D_MODEL = 64


def _configs(experts=8, top_k=2, d_ff=48, shared=0, gated=True, cf=1.25):
    """The port's and the JAX package's granite-moe smoke config with the
    MoE geometry replaced (the same in both)."""
    kw = dict(num_experts=experts, experts_per_token=top_k, expert_d_ff=d_ff,
              num_shared_experts=shared, capacity_factor=cf)
    t = dataclasses.replace(smoke_variant(get_config("granite-moe-1b-a400m"), d_model=D_MODEL),
                            moe=MoEConfig(**kw), mlp_gated=gated)
    j = dataclasses.replace(jsmoke(jget_config("granite-moe-1b-a400m"), d_model=D_MODEL),
                            moe=JMoEConfig(**kw), mlp_gated=gated)
    return t, j


def _params(cfg, R, seed):
    """R tenants' seeded numpy weights in the reference's layout, stacked."""
    rng = np.random.RandomState(seed)
    m, d = cfg.moe, cfg.d_model
    e, f = m.num_experts, m.expert_d_ff

    def w(*shape):
        return (rng.standard_normal((R,) + shape) / np.sqrt(shape[-2])).astype(np.float32)

    p = {"router": w(d, e), "w_gate": w(e, d, f), "w_up": w(e, d, f), "w_down": w(e, f, d)}
    if m.num_shared_experts:
        sf = m.num_shared_experts * f
        p["shared"] = {"up": w(d, sf), "down": w(sf, d)}
        if cfg.mlp_gated:
            p["shared"]["gate"] = w(d, sf)
    return p


def _compare(tcfg, jcfg, R, B, S, seed):
    """Both packages on the same inputs; returns the port's keep mask."""
    p = _params(tcfg, R, seed)
    x = np.random.RandomState(seed + 1).standard_normal((R, B, S, D_MODEL)).astype(np.float32)
    tp = jax.tree.map(torch.from_numpy, p)
    y, aux = moe.moe_forward(tp, torch.from_numpy(x), tcfg)
    assert y.shape == (R, B, S, D_MODEL) and aux.shape == (R,)
    for r in range(R):
        jy, jaux = jmoe.moe_forward(jax.tree.map(lambda a: jnp.asarray(a[r]), p),
                                    jnp.asarray(x[r]), jcfg)
        np.testing.assert_allclose(y[r].numpy(), np.asarray(jy), rtol=RTOL, atol=ATOL)
        np.testing.assert_allclose(float(aux[r]), float(jaux), rtol=RTOL, atol=ATOL)
    return moe.route(tp, torch.from_numpy(x), tcfg)[-1]


def test_capacity_is_the_references():
    tcfg, _ = _configs()
    for S in (1, 3, 24, 777):
        assert moe.capacity(tcfg, S) == int(max(1, 1.25 * S * 2 / 8))


def test_prefill_that_drops_at_capacity_matches_jax():
    """24 tokens, top-2 of 8 experts: capacity int(1.25 * 24 * 2 / 8) = 7
    slots an expert, and some expert of some sequence is chosen more often
    (the pairs past its capacity are dropped, in the reference's order)."""
    tcfg, jcfg = _configs()
    keep = _compare(tcfg, jcfg, R=2, B=3, S=24, seed=0)
    assert moe.capacity(tcfg, 24) == 7
    assert not bool(keep.all()), "no pair was dropped: the capacity path did not run"
    assert bool(keep.any())


def test_shared_expert_and_tight_capacity_match_jax():
    """llama4-style top-1 with a shared expert, capacity factor 1.0."""
    tcfg, jcfg = _configs(experts=4, top_k=1, shared=1, cf=1.0)
    keep = _compare(tcfg, jcfg, R=1, B=2, S=17, seed=3)
    assert not bool(keep.all())


def test_ungated_experts_match_jax():
    tcfg, jcfg = _configs(gated=False)
    _compare(tcfg, jcfg, R=1, B=2, S=9, seed=5)


def test_decode_step_matches_jax_and_drops_nothing():
    """S = 1, as in a merged decode step: capacity 1 slot an expert, and a
    token's k choices are k distinct experts, so every pair is kept."""
    tcfg, jcfg = _configs(shared=1)
    keep = _compare(tcfg, jcfg, R=3, B=4, S=1, seed=7)
    assert moe.capacity(tcfg, 1) == 1 and bool(keep.all())


def test_tenants_are_independent():
    """Tenant r's output is its own call's: the tenant axis is a batch."""
    tcfg, _ = _configs()
    p = jax.tree.map(torch.from_numpy, _params(tcfg, 2, seed=9))
    x = torch.from_numpy(np.random.RandomState(10).standard_normal((2, 2, 10, D_MODEL))
                         .astype(np.float32))
    both, _ = moe.moe_forward(p, x, tcfg)
    for r in range(2):
        one, _ = moe.moe_forward({k: v[r:r + 1] for k, v in p.items()}, x[r:r + 1], tcfg)
        np.testing.assert_allclose(both[r].numpy(), one[0].numpy(), rtol=RTOL, atol=ATOL)
