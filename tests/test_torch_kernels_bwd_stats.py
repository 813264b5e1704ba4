"""What the forward kernels save for their backward, and the backward
kernels' routing, on the CPU.

- ``ref.attention_lse`` (the plain version of the log-sum-exp K4's wgmma
  forward writes) against ``jax.nn.logsumexp`` of the JAX reference's
  scaled, masked scores: GQA, a sliding window, rows with no visible key.
- ``ref.wkv6_chunk_states`` (the plain version of the chunk-entry states
  K5's chunked forward writes) against the JAX serving prefill's final-state
  scan on each prefix of 16 c steps, also on heads of 32 zero-padded to 64
  as the wrapper runs them.
- An emulation in torch of each new backward kernel's arithmetic, from the
  saved statistics, against ``jax.vjp`` of the reference: K4-bwd ``wgmma``
  (P = exp(scale S - lse), P and dS rounded to bf16 as its A operands) and
  K5-bwd ``cluster`` (each chunk's states recomputed from its saved entry
  state, dr, dk, dw and du summed over four 16-column value slices in slice
  order, with each slice's own v . do in the bonus terms).
- ``bwd_variant``'s rules, and the wrappers refusing what a variant does not
  take before any launch.

Tolerances, each stated where it is used: float32 sums in another order
(1e-5 of the largest magnitude, as ``test_torch_kernels_bwd.py``), and for
the bf16 emulation the card's own ``chip_smoke.BWD_TOL`` and
``BWD_AUTOGRAD_TOL``.
"""

import math
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.kernels import ref as jref  # noqa: E402
from repro.models.rwkv import _wkv_final_state  # noqa: E402

from repro_torch.kernels import _build, ref  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import wkv6_scan as wk  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
F32_SHARE = 1e-5


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, what, share=F32_SHARE):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0, atol=share * max(1.0, float(np.abs(want).max())),
                               err_msg=what)


@pytest.fixture
def smoke(monkeypatch):
    monkeypatch.syspath_prepend(str(ROOT))
    import chip_smoke

    return chip_smoke


# ------------------------------------------------------------------ K4: lse
LSE_CASES = [  # B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset
    (2, 4, 4, 37, 37, 32, True, 0, 0),
    (1, 8, 2, 50, 50, 64, True, 0, 0),        # GQA 4
    (1, 4, 1, 45, 45, 16, True, 7, 0),        # sliding window, MQA
    (1, 2, 2, 20, 30, 16, True, 0, -4),       # queries before every key: rows with none visible
    (1, 2, 1, 33, 33, 16, False, 9, 0),       # non-causal window
]


@pytest.mark.parametrize("case", LSE_CASES, ids=lambda c: "-".join(map(str, c)))
def test_attention_lse_matches_jax_logsumexp(case):
    B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset = case
    rng = np.random.RandomState(Sq + D)
    q = rng.standard_normal((B, Hq, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, Hkv, Skv, D)).astype(np.float32)
    got = ref.attention_lse(_t(q), _t(k), causal=causal, window=window, q_offset=q_offset)
    g = Hq // Hkv
    s = jnp.einsum("bhgqd,bhkd->bhgqk", jnp.asarray(q).reshape(B, Hkv, g, Sq, D),
                   jnp.asarray(k)) * D ** -0.5
    qp = jnp.arange(Sq)[:, None] + q_offset
    kp = jnp.arange(Skv)[None, :]
    mask = jnp.ones((Sq, Skv), bool)
    if causal:
        mask &= qp >= kp
    if window > 0:
        mask &= qp - kp < window
    want = np.asarray(jax.nn.logsumexp(jnp.where(mask, s, -jnp.inf), axis=-1)).reshape(B, Hq, Sq)
    none = ~np.asarray(mask).any(axis=-1)
    assert got.shape == (B, Hq, Sq) and got.dtype == torch.float32
    assert np.isinf(got.numpy()[..., none]).all() and (got.numpy()[..., none] > 0).all()
    if q_offset < 0:
        assert none.any()  # the case exercises rows with no visible key
    _close(got[..., ~none], want[..., ~none], "lse")


# ------------------------------------------------------------------ K5: chunk states
@pytest.mark.parametrize("regime", ["strong", "weak"])
@pytest.mark.parametrize("N", [32, 64])
def test_wkv6_chunk_states_match_jax_prefix_scans(N, regime):
    """Entry c is the JAX final-state scan over the first 16 c steps (T = 53,
    not a multiple of 16); run on heads zero-padded to the kernel's 64 as the
    wrapper pads them, the live block is the same and the rest 0."""
    BH, T = 3, 53
    rng = np.random.RandomState(N + T)
    k = (0.5 * rng.standard_normal((BH, T, N))).astype(np.float32)
    v = (0.5 * rng.standard_normal((BH, T, N))).astype(np.float32)
    mean, std = (1.0, 1.0) if regime == "strong" else (-8.0, 0.5)
    w = (mean + std * rng.standard_normal((BH, T, N))).astype(np.float32)
    NP, VP = wk.padded_dims(N, N)
    shape = wk.chunk_states_shape(BH, T, N, N)
    assert shape == (BH, 4, NP, VP)

    def pad(a, width):
        out = np.zeros(a.shape[:-1] + (width,), np.float32)
        out[..., :a.shape[-1]] = a
        return out

    got = ref.wkv6_chunk_states(_t(pad(k, NP)), _t(pad(v, VP)), _t(pad(w, NP)))
    assert tuple(got.shape) == shape
    zero = jnp.zeros((BH, N, N), jnp.float32)
    for c in range(shape[1]):
        L = 16 * c
        want = zero if L == 0 else _wkv_final_state(*(jnp.asarray(a[:, :L]) for a in (k, v, w)),
                                                    zero)
        _close(got[:, c, :N, :N], want, f"chunk {c}")
    if N < NP:
        assert float(got[:, :, N:].abs().max() + got[:, :, :, N:].abs().max()) == 0.0


# ------------------------------------------------------------------ emulations
def _attn_bf16_inputs(B, Hq, Hkv, S, D, seed):
    rng = np.random.RandomState(seed)
    return [torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to(torch.bfloat16)
            for s in ((B, Hq, S, D), (B, Hkv, S, D), (B, Hkv, S, D), (B, Hq, S, D))]


def wgmma_bwd_emulation(q, k, v, o, do, lse, *, window=0):
    """K4-bwd ``wgmma``'s arithmetic: P = exp(scale S - lse) from the
    forward's lse (0 where masked), delta = rowsum(dO o O), dS = P o (dP -
    delta) in float32; P and dS rounded to bf16 as the A operands of dV, dK
    and dQ; every sum float32; the GQA sum inside dK and dV."""
    B, Hq, S, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    scale = D ** -0.5
    qf, dof, of = (t.float().reshape(B, Hkv, g, S, D) for t in (q, do, o))
    kf, vf = k.float()[:, :, None], v.float()[:, :, None]
    mask = ref._mask(S, S, 0, True, window, 0, q.device)
    s = qf @ kf.transpose(-1, -2) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(B, Hkv, g, S, 1)), 0.0)
    delta = (dof * of).sum(-1, keepdim=True)
    ds = p * (dof @ vf.transpose(-1, -2) - delta)
    pb, dsb = (t.to(torch.bfloat16).float() for t in (p, ds))
    dv = (pb.transpose(-1, -2) @ dof).sum(2)
    dk = (dsb.transpose(-1, -2) @ qf).sum(2) * scale
    dq = (dsb @ kf) * scale
    return dq.reshape(B, Hq, S, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@pytest.mark.parametrize("case", [(1, 4, 4, 100, 64, 0), (1, 8, 2, 70, 64, 0),
                                  (1, 4, 2, 90, 128, 24)],
                         ids=["mha", "gqa4", "window-d128"])
def test_wgmma_bwd_arithmetic_within_the_cards_tolerance(case, smoke):
    """In bf16, against ``ref.attention_bwd`` (chip_smoke.BWD_TOL) and
    ``jax.vjp`` of the reference in float32 (BWD_AUTOGRAD_TOL): the bf16
    rounding of P and dS stays inside the tolerances the card holds the
    kernel to."""
    B, Hq, Hkv, S, D, window = case
    q, k, v, do = _attn_bf16_inputs(B, Hq, Hkv, S, D, seed=S)
    o = ref.attention(q, k, v, window=window)
    lse = ref.attention_lse(q, k, window=window)
    got = wgmma_bwd_emulation(q, k, v, o, do, lse, window=window)
    want = ref.attention_bwd(q, k, v, o, do, window=window)
    _, vjp = jax.vjp(lambda a, b, c: jref.attention(a, b, c, causal=True, window=window),
                     *(jnp.asarray(t.float().numpy()) for t in (q, k, v)))
    auto = [torch.from_numpy(np.array(x)) for x in vjp(jnp.asarray(do.float().numpy()))]
    for ref_grads, tol in ((want, smoke.BWD_TOL["torch.bfloat16"]),
                           (auto, smoke.BWD_AUTOGRAD_TOL["torch.bfloat16"])):
        rtol, share = tol
        for g_, w_, name in zip(got, ref_grads, ("dq", "dk", "dv")):
            g32, w32 = g_.float(), w_.float()
            bound = share * w32.abs().max() + rtol * w32.abs()
            assert bool(((g32 - w32).abs() <= bound).all()), name


def cluster_bwd_emulation(r, k, v, w, u, do, ckpt, slices=4, chunk=16):
    """K5-bwd ``cluster``'s decomposition in float32: per value slice of
    V / slices columns, chunks walked last to first, each chunk's states
    recomputed from its saved entry state, G carried across chunks; dv per
    slice; dr, dk, dw and du as per-slice partials (each slice's own v . do
    in the bonus terms) summed in slice order."""
    BH, T, N = r.shape
    V = v.shape[-1]
    VS = V // slices
    nc = -(-T // chunk)
    Tp = nc * chunk

    def pad(t):  # steps past T: r = k = v = do = 0, w = 0
        out = torch.zeros((BH, Tp, t.shape[-1]))
        out[:, :T] = t
        return out

    r_, k_, v_, w_, do_ = (pad(t.float()) for t in (r, k, v, w, do))
    ew = torch.exp(w_)
    d = torch.exp(-ew)
    uf = u.float().repeat(BH // u.shape[0], 1)
    ruk = (r_ * uf[:, None] * k_).sum(-1)
    parts = torch.zeros((slices, 3, BH, Tp, N))
    du_parts = torch.zeros((slices, BH, N))
    dv = torch.zeros((BH, Tp, V))
    for sl in range(slices):
        cols = slice(sl * VS, (sl + 1) * VS)
        G = torch.zeros((BH, N, VS))
        for c in reversed(range(nc)):
            S = ckpt[:, c, :, cols].clone()
            states = []
            for t in range(c * chunk, (c + 1) * chunk):
                states.append(S)
                S = d[:, t, :, None] * S + k_[:, t, :, None] * v_[:, t, None, cols]
            for t in reversed(range(c * chunk, (c + 1) * chunk)):
                Sp, o, vv = states[t - c * chunk], do_[:, t, cols], v_[:, t, cols]
                vdo = (vv * o).sum(-1, keepdim=True)
                parts[sl, 0, :, t] = (Sp * o[:, None]).sum(-1) + uf * k_[:, t] * vdo
                parts[sl, 1, :, t] = (G * vv[:, None]).sum(-1) + uf * r_[:, t] * vdo
                parts[sl, 2, :, t] = -ew[:, t] * d[:, t] * (G * Sp).sum(-1)
                dv[:, t, cols] = (G * k_[:, t, :, None]).sum(1) + ruk[:, t, None] * o
                du_parts[sl] += r_[:, t] * k_[:, t] * vdo
                G = d[:, t, :, None] * G + r_[:, t, :, None] * o[:, None]
    total, du = parts[0], du_parts[0]
    for sl in range(1, slices):
        total, du = total + parts[sl], du + du_parts[sl]
    du = du.reshape(BH // u.shape[0], u.shape[0], N).sum(0)
    return total[0, :, :T], total[1, :, :T], dv[:, :T], total[2, :, :T], du


@pytest.mark.parametrize("regime", ["typical", "strong", "weak"])
def test_cluster_bwd_decomposition_matches_jax_vjp(regime):
    """From ``ref.wkv6_chunk_states``, at T = 37 (not a multiple of 16), u
    (H, N) shared over the batch: each gradient within 1e-5 of its largest
    magnitude of ``jax.vjp`` of the reference scan."""
    BH, H, T, N = 4, 2, 37, 64
    mean, std = {"typical": (-3.0, 1.0), "strong": (1.0, 1.0), "weak": (-8.0, 0.5)}[regime]
    rng = np.random.RandomState(7)
    r, k, v = ((0.5 * rng.standard_normal((BH, T, N))).astype(np.float32) for _ in range(3))
    w = (mean + std * rng.standard_normal((BH, T, N))).astype(np.float32)
    u = (0.3 * rng.standard_normal((H, N))).astype(np.float32)
    do = rng.standard_normal((BH, T, N)).astype(np.float32)
    ckpt = ref.wkv6_chunk_states(_t(k), _t(v), _t(w))
    got = cluster_bwd_emulation(*(_t(a) for a in (r, k, v, w, u, do)), ckpt)

    def jfn(r_, k_, v_, w_, u_):
        return jref.wkv6_scan(r_, k_, v_, w_, jnp.tile(u_, (BH // H, 1)))

    _, vjp = jax.vjp(jfn, *(jnp.asarray(a) for a in (r, k, v, w, u)))
    for g_, w_, name in zip(got, vjp(jnp.asarray(do)), ("dr", "dk", "dv", "dw", "du")):
        _close(g_, w_, name)


# ------------------------------------------------------------------ routing
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("D", fa.SUPPORTED_HEAD_DIMS)
def test_flash_bwd_variant_rule(D, dtype):
    """wgmma for bf16 at D 64, 128, 256 (where the forward writes the lse),
    cuda_core for float32 and bf16 at D 32 and 112."""
    want = "wgmma" if dtype == torch.bfloat16 and D in (64, 128, 256) else "cuda_core"
    assert fa.bwd_variant(dtype, D) == want


@pytest.mark.parametrize("T", [1, 16, 17, 512, 777])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wkv_bwd_variant_rule(dtype, T):
    assert wk.bwd_variant(dtype, T) == "cluster"
    assert wk.chunk_states_shape(2, T, 32, 16) == (2, math.ceil(T / 16), 64, 64)


@pytest.fixture
def no_launch(monkeypatch):
    """The wrappers' checks on CPU tensors: the device check passes, and
    reaching a launch is reported as such."""
    monkeypatch.setattr(_build, "check_device", lambda t: None)

    def load(name):
        raise AssertionError(f"{name}: reached the launch")

    monkeypatch.setattr(_build, "load", load)


def _attn(dtype=torch.bfloat16, D=64, S=16):
    q = torch.zeros((1, 2, S, D), dtype=dtype)
    return q, q.clone(), q.clone()


def _lse(S=16, dtype=torch.float32):
    return torch.zeros((1, 2, S), dtype=dtype)


FLASH_REFUSALS = {
    "fwd lse on cuda_core (f32)": lambda: fa.flash_attention(*_attn(torch.float32), lse=_lse()),
    # bf16 D 112 runs wgmma by the rule (which may write an lse); the prior,
    # asked for by name, writes none
    "fwd lse on cuda_core (bf16 D 112)": lambda: fa.flash_attention(*_attn(D=112), lse=_lse(),
                                                                    kernel="cuda_core"),
    "fwd lse of the wrong shape": lambda: fa.flash_attention(*_attn(), lse=_lse(S=15)),
    "fwd lse in bf16": lambda: fa.flash_attention(*_attn(), lse=_lse(dtype=torch.bfloat16)),
    "bwd wgmma without lse": lambda: fa.flash_attention_bwd(*_attn(), *_attn()[:2]),
    "bwd wgmma lse of the wrong shape": lambda: fa.flash_attention_bwd(
        *_attn(), *_attn()[:2], lse=_lse(S=8)),
    "bwd wgmma asked for f32": lambda: fa.flash_attention_bwd(
        *_attn(torch.float32), *_attn(torch.float32)[:2], kernel="wgmma"),
    "bwd no such kernel": lambda: fa.flash_attention_bwd(*_attn(), *_attn()[:2], lse=_lse(),
                                                         kernel="fused"),
}


@pytest.mark.parametrize("what", sorted(FLASH_REFUSALS))
def test_flash_wrappers_refuse_before_any_launch(what, no_launch):
    with pytest.raises(ValueError):
        FLASH_REFUSALS[what]()


def _wkv(N=64, T=20, dtype=torch.float32):
    x = torch.zeros((2, T, N), dtype=dtype)
    return x, x.clone(), x.clone(), x.clone(), torch.zeros((2, N))


WKV_REFUSALS = {
    "fwd ckpt on sequential": lambda: wk.wkv6_scan(
        *_wkv(), kernel="sequential", ckpt=torch.zeros(wk.chunk_states_shape(2, 20, 64, 64))),
    "fwd ckpt of the wrong shape": lambda: wk.wkv6_scan(*_wkv(), ckpt=torch.zeros((2, 1, 64, 64))),
    "fwd ckpt unpadded (N 32)": lambda: wk.wkv6_scan(*_wkv(32), ckpt=torch.zeros((2, 2, 32, 32))),
    "bwd cluster without ckpt": lambda: wk.wkv6_scan_bwd(*_wkv(), _wkv()[0]),
    "bwd ckpt of the wrong shape": lambda: wk.wkv6_scan_bwd(*_wkv(), _wkv()[0],
                                                            ckpt=torch.zeros((2, 2, 64, 32))),
    "bwd ckpt in bf16": lambda: wk.wkv6_scan_bwd(
        *_wkv(), _wkv()[0], ckpt=torch.zeros((2, 2, 64, 64), dtype=torch.bfloat16)),
    "bwd no such kernel": lambda: wk.wkv6_scan_bwd(*_wkv(), _wkv()[0], kernel="sequential"),
}


@pytest.mark.parametrize("what", sorted(WKV_REFUSALS))
def test_wkv_wrappers_refuse_before_any_launch(what, no_launch):
    with pytest.raises(ValueError):
        WKV_REFUSALS[what]()


@pytest.mark.parametrize("call", ["flash fwd", "flash bwd wgmma", "flash bwd prior",
                                  "wkv fwd", "wkv bwd cluster", "wkv bwd prior"])
def test_wrappers_reach_the_launch_with_what_they_take(call, no_launch):
    """The controls of the refusals above: the same calls, well formed, pass
    every check and reach the launch."""
    calls = {
        "flash fwd": lambda: fa.flash_attention(*_attn(), lse=_lse()),
        "flash bwd wgmma": lambda: fa.flash_attention_bwd(*_attn(), *_attn()[:2], lse=_lse()),
        "flash bwd prior": lambda: fa.flash_attention_bwd(*_attn(), *_attn()[:2],
                                                          kernel="cuda_core"),
        "wkv fwd": lambda: wk.wkv6_scan(*_wkv(32), ckpt=torch.zeros(
            wk.chunk_states_shape(2, 20, 32, 32))),
        "wkv bwd cluster": lambda: wk.wkv6_scan_bwd(*_wkv(), _wkv()[0], ckpt=torch.zeros(
            wk.chunk_states_shape(2, 20, 64, 64))),
        "wkv bwd prior": lambda: wk.wkv6_scan_bwd(*_wkv(), _wkv()[0], kernel="chunked"),
    }
    with pytest.raises(AssertionError, match="reached the launch"):
        calls[call]()
