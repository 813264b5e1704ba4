"""The port's state pass (K5-state, ``wkv6_state``) against the JAX
package's ``_wkv_final_state``.

The plain ``ref.wkv6_state`` follows the reference's op order, so it must
agree with it to float32 rounding (STATE_TOL). The kernel's segmented math
(segments from zero, per-row decay products, the ordered combine), emulated
here in torch, regroups the same sums: it is held to the JAX kernel test's
tolerance (WKV_TOL, also chip_smoke.py's for K5's state), which a state
rolled with w rounded to bf16 (ROADMAP F4) fails. The rest covers the
segment rule, the wrapper's refusal of CPU tensors, the calls a prefill
makes by dtype, and the meta device's count.
"""

import contextlib
import ctypes
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.models.rwkv import _wkv_final_state  # noqa: E402

from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import _build, ops, ref  # noqa: E402
from repro_torch.kernels import wkv6_scan as wk  # noqa: E402
from repro_torch.kernels import wkv6_state as wks  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.models import build_model, rwkv  # noqa: E402

STATE_TOL = 1e-5           # the reference's own order: float32 rounding only
WKV_TOL = (2e-4, 2e-3)     # (rtol, atol): the same sums regrouped by segment
TS = (1, 15, 16, 17, 63, 64, 65, 742)
HEADS = ((8, 8), (16, 32), (32, 16), (64, 64), (64, 8))  # (N, V)


def _bf16(a):
    """float32 numpy values exactly representable in bf16."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _inputs(seed, B, H, T, N, V, w_low=-8.0, w_high=2.0):
    """k, v (bf16 values) and float32 w as (B, T, H, X) projections, the
    model's layout; w uniform in [w_low, w_high] (at the top a decay of
    exp(-e^2) ~ 6e-4 a step, so segment products underflow); a random
    state."""
    rng = np.random.RandomState(seed)
    k = _bf16(rng.standard_normal((B, T, H, N)).astype(np.float32) * 0.5)
    v = _bf16(rng.standard_normal((B, T, H, V)).astype(np.float32) * 0.5)
    w = rng.uniform(w_low, w_high, (B, T, H, N)).astype(np.float32)
    s0 = rng.standard_normal((B * H, N, V)).astype(np.float32)
    return k, v, w, s0


def _views(k, v, w):
    """The model's (B, H, T, X) views: k, v bf16, w float32."""
    return (torch.from_numpy(k).to(torch.bfloat16).transpose(1, 2),
            torch.from_numpy(v).to(torch.bfloat16).transpose(1, 2),
            torch.from_numpy(w).transpose(1, 2))


def _oracle(k, v, w, s0):
    """The reference's ``_wkv_final_state`` on (BH, T, X) copies."""
    B, T, H = k.shape[:3]

    def heads(a, dtype):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, T, a.shape[-1]), dtype)

    state = jnp.zeros((B * H, k.shape[-1], v.shape[-1]), jnp.float32) if s0 is None \
        else jnp.asarray(s0)
    return np.asarray(_wkv_final_state(heads(k, jnp.bfloat16), heads(v, jnp.bfloat16),
                                       heads(w, jnp.float32), state))


def _close(got, want, tol):
    rtol, atol = tol
    return bool(np.all(np.abs(got - want) <= atol + rtol * np.abs(want)))


def emulate_segmented(k, v, w, s0, G):
    """The kernel's arithmetic in torch float32 over ``G`` segments
    (``wkv6_state.segment_bounds``): each segment rolls from zero (segment 0
    from ``s0``) with s = d s + k v and keeps its per-row decay product; the
    state after step T is S_0, then diag(D_g) S + S_g in segment order."""
    B, H, T, N = k.shape
    V = v.shape[-1]
    kf, vf = k.reshape(B * H, T, N).float(), v.reshape(B * H, T, V).float()
    decay = torch.exp(-torch.exp(w.reshape(B * H, T, N).float()))
    parts = []
    for g, (a, b) in enumerate(wks.segment_bounds(T, G)):
        S = torch.zeros((B * H, N, V)) if g or s0 is None else s0.clone()
        D = torch.ones((B * H, N))
        for t in range(a, b):
            S = decay[:, t, :, None] * S + kf[:, t, :, None] * vf[:, t, None, :]
            D = D * decay[:, t]
        parts.append((S, D))
    S = parts[0][0]
    for S_g, D_g in parts[1:]:
        S = D_g[:, :, None] * S + S_g
    return S


@pytest.mark.parametrize("N,V", HEADS, ids=str)
@pytest.mark.parametrize("T", TS)
def test_plain_state_matches_the_reference(T, N, V):
    """From a random and a zero state, strided views, decays that underflow."""
    k, v, w, s0 = _inputs(T * 100 + N + V, 2, 2, T, N, V)
    views = _views(k, v, w)
    for init in (s0, None):
        got = ref.wkv6_state(*views, None if init is None else torch.from_numpy(init))
        assert got.shape == (4, N, V) and got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), _oracle(k, v, w, init), rtol=STATE_TOL,
                                   atol=STATE_TOL)


@pytest.mark.parametrize("T,G", [(742, g) for g in range(1, wks.MAX_SEGMENTS + 1)]
                         + [(65, 1), (128, 2), (513, 8)], ids=str)
def test_the_segmented_math_matches_the_reference(T, G):
    """Every segment count the rule can pick, at a median prompt's 742 steps
    and at its edges, from a random state, with decays that underflow."""
    N, V = 64, 32
    assert G <= max(1, T // wks.TILE)
    k, v, w, s0 = _inputs(7 + G, 1, 3, T, N, V)
    want = _oracle(k, v, w, s0)
    got = emulate_segmented(*_views(k, v, w), torch.from_numpy(s0), G).numpy()
    assert _close(got, want, WKV_TOL), float(np.abs(got - want).max())
    zero = emulate_segmented(*_views(k, v, w), None, G).numpy()
    assert _close(zero, _oracle(k, v, w, None), WKV_TOL)


def test_the_segmented_math_at_the_rules_own_counts():
    """The count ``segments`` picks for a few (BH, T), emulated on a slice of
    the heads (the rule depends on BH, the math on each head alone)."""
    for BH, T in ((32, 742), (1, 300), (40, 200), (64, 700), (300, 700)):
        G = wks.segments(BH, T)
        k, v, w, s0 = _inputs(BH + T, 1, 2, T, 16, 16)
        got = emulate_segmented(*_views(k, v, w), torch.from_numpy(s0), G).numpy()
        assert _close(got, _oracle(k, v, w, s0), WKV_TOL), (BH, T, G)


def test_w_rounded_to_bf16_fails_the_tolerance():
    """F4's own fault: the state rolled with w rounded to bf16 (what the
    outputs' scan takes) is not the reference's, at the tolerance the
    segmented math passes. Decays slow enough (w ~ N(-6, 1)) that the
    rounding accumulates over a median prompt."""
    rng = np.random.RandomState(3)
    B, T, H, N = 1, 742, 4, 64
    k = _bf16(rng.standard_normal((B, T, H, N)).astype(np.float32) * 0.5)
    v = _bf16(rng.standard_normal((B, T, H, N)).astype(np.float32) * 0.5)
    w = (rng.standard_normal((B, T, H, N)) - 6.0).astype(np.float32)
    s0 = rng.standard_normal((B * H, N, N)).astype(np.float32)
    want = _oracle(k, v, w, s0)
    kt, vt, wt = _views(k, v, w)
    assert _close(emulate_segmented(kt, vt, wt, torch.from_numpy(s0), 8).numpy(), want, WKV_TOL)
    rounded = ref.wkv6_state(kt, vt, wt.to(torch.bfloat16).float(), torch.from_numpy(s0))
    assert not _close(rounded.numpy(), want, WKV_TOL)


def test_the_segment_rule_at_its_edges():
    R = wks.RESIDENT_CLUSTERS
    assert sorted(R) == list(range(1, wks.MAX_SEGMENTS + 1))
    assert all(R[g] >= R[g + 1] for g in range(1, wks.MAX_SEGMENTS))
    assert wks.segments(32, 742) == 7                   # a median prompt: 32 clusters of 7 fit
    assert wks.segments(R[8], 32768) == 8 and wks.segments(R[8] + 1, 32768) == 7
    assert wks.segments(1, 32768) == wks.MAX_SEGMENTS   # capped by the portable cluster
    assert wks.segments(32, 63) == wks.segments(32, 1) == 1   # shorter than one tile
    assert wks.segments(32, 64) == 1 and wks.segments(32, 127) == 1
    assert wks.segments(1, 128) == 2 and wks.segments(1, 191) == 2
    assert wks.segments(R[2] + 1, 10**5) == 1 and wks.segments(R[1] + 1, 10**5) == 1
    for BH in (1, 7, 30, 31, 32, 33, 64, 100, 264, 1000):
        for T in (1, 63, 64, 65, 127, 128, 500, 742, 4096, 32768):
            G = wks.segments(BH, T)
            assert 1 <= G <= wks.MAX_SEGMENTS and (G == 1 or G <= T // wks.TILE)
            assert G == 1 or BH <= R[G]                   # one wave of clusters
            if G < min(wks.MAX_SEGMENTS, T // wks.TILE):
                assert BH > R[G + 1]                      # the largest that fits
            bounds = wks.segment_bounds(T, G)
            assert bounds[0][0] == 0 and bounds[-1][1] == T
            assert all(a < b for a, b in bounds)          # none empty
            assert all(b == a2 for (_, b), (a2, _) in zip(bounds, bounds[1:]))
            assert G == 1 or min(b - a for a, b in bounds) >= wks.TILE


def test_the_kernel_wrapper_refuses_cpu_tensors():
    """The CUDA wrapper launches or raises; it never falls back."""
    k, v, w = _views(*_inputs(1, 1, 2, 10, 64, 64)[:3])
    with pytest.raises(ValueError, match="CUDA tensor"):
        wks.wkv6_state(k, v, w)


def test_ops_route_cpu_tensors_to_the_plain_version():
    k, v, w, s0 = _inputs(2, 1, 2, 20, 16, 16)
    kt, vt, wt = _views(k, v, w)
    ops.reset_counters()
    buf = torch.from_numpy(s0.copy())
    got = ops.wkv6_state(kt, vt, wt, init_state=buf, final_state=buf)
    assert got is buf and ops.COUNTERS["wkv6_state"].plain_calls == 1
    assert torch.equal(buf, ref.wkv6_state(kt, vt, wt, torch.from_numpy(s0)))
    ops.wkv6_state_plain(kt, vt, wt)
    assert ops.COUNTERS["wkv6_state"].plain_calls == 2
    assert all(c.launches == 0 for c in ops.COUNTERS.values())


@pytest.mark.parametrize("N,V", [(24, 32), (32, 48), (128, 64), (4, 4)])
def test_a_head_size_outside_the_rule_raises(N, V, monkeypatch):
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    k, v, w = _views(*_inputs(4, 1, 2, 5, N, V)[:3])
    with pytest.raises(ValueError, match=r"takes N and V in \(8, 16, 32, 64\)"):
        wks.wkv6_state(k, v, w)


def test_the_wrapper_refuses_a_rounded_w(monkeypatch):
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    k, v, w = _views(*_inputs(5, 1, 2, 5, 16, 16)[:3])
    with pytest.raises(TypeError, match="w must be float32"):
        wks.wkv6_state(k, v, w.to(torch.bfloat16))


class _StubLib:
    """Stands in for the built libraries: records each launch's scalar
    arguments (and the state pass's strides) and launches nothing."""

    def __init__(self):
        self.calls = []

    def repro_wkv6_scan(self, *a):
        # r, k, v, w, u, s0, s_out, ckpt, out, B, H, T, N, V, u_rows, strides, dtype, w_f32, ...
        self.calls.append(("wkv6_scan", {"s0": a[5], "s_out": a[6], "T": a[11], "N": a[12],
                                         "w_f32": a[17]}))
        return 0

    def repro_wkv6_state(self, *a):
        # k, v, w, s0, s_out, B, H, T, N, V, strides, dtype, segments, stream
        strides = list((ctypes.c_longlong * 9).from_address(a[10]))
        self.calls.append(("wkv6_state", {"s0": a[3], "s_out": a[4], "B": a[5], "H": a[6],
                                          "T": a[7], "N": a[8], "V": a[9], "strides": strides,
                                          "dtype": a[11], "segments": a[12]}))
        return 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_prefill_launches_one_scan_and_in_bf16_one_state_pass_per_layer(dtype, monkeypatch):
    """The smoke variant's prefill on the kernels' route with the launches
    stubbed: per layer one ``wkv6_scan`` and, in bf16 only, one
    ``wkv6_state`` from float32 w into the layer's cache in place (the
    scan's own state a scratch buffer), over ``segments(BH, T)`` segments;
    as ``rwkv.prefill_launches`` says."""
    lib = _StubLib()
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    monkeypatch.setattr(ops, "wkv6_scan", wk.wkv6_scan)   # the CUDA route for CPU tensors
    monkeypatch.setattr(ops, "wkv6_state", wks.wkv6_state)
    cfg = dataclasses.replace(smoke_variant(get_config("rwkv6-1.6b")), dtype=dtype)
    H, N = rwkv.dims(cfg)
    B, S = 2, 70
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    caches = model.init_caches(B, 128)
    tokens = torch.randint(1, cfg.vocab_size, (B, S), generator=torch.Generator().manual_seed(1))
    ops.reset_counters()
    with torch.no_grad():
        model.forward_prefill(params, tokens, 128, caches=caches, start=0)
    L = cfg.num_layers
    want = {op: n * L for op, n in rwkv.prefill_launches(getattr(torch, dtype)).items()}
    got = {name: c.launches for name, c in ops.COUNTERS.items() if c.launches}
    assert got == want == ({"wkv6_scan": L, "wkv6_state": L} if dtype == "bfloat16"
                           else {"wkv6_scan": L})
    assert all(c.plain_calls == 0 for c in ops.COUNTERS.values())
    assert [n for n, _ in lib.calls] == list(want) * L
    if dtype == "float32":
        return
    assert ops.COUNTERS["wkv6_state"].variants == {wks.VARIANT: L}
    assert ops.COUNTERS["wkv6_state"].sizes == {S: L}  # a layer's launch, T = S
    for layer in range(L):
        scan, state = lib.calls[2 * layer][1], lib.calls[2 * layer + 1][1]
        wkv = caches["wkv"][layer].data_ptr()
        assert scan["w_f32"] == 0 and scan["s_out"] != wkv  # rounded w; its state a scratch
        assert state["s0"] == state["s_out"] == wkv and state["dtype"] == 1
        assert (state["B"], state["H"], state["T"], state["N"], state["V"]) == (B, H, S, N, N)
        assert state["segments"] == wks.segments(B * H, S) == 1
        # the (B, H, S, N) views of (B, S, H, N) projections, passed as they are
        assert state["strides"] == [S * H * N, N, H * N] * 3


def test_the_wrapper_counts_its_launches_by_length(monkeypatch):
    """Each launch counts once in all, once under its variant and once
    under its length T (the piece sizes' launches that chip_smoke.py's
    K5-state rows report); a call that raises counts nothing."""
    lib = _StubLib()
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    ops.reset_counters()
    gen = torch.Generator().manual_seed(3)
    for T in (512, 64, 1, 64, 1, 1):
        k, v = (torch.randn(2, T, 32, generator=gen).to(torch.bfloat16) for _ in range(2))
        wks.wkv6_state(k, v, torch.randn(2, T, 32, generator=gen))
    with pytest.raises(TypeError):
        wks.wkv6_state(k, v, torch.randn(2, 1, 32, generator=gen).to(torch.bfloat16))
    c = ops.COUNTERS["wkv6_state"]
    assert (c.launches, c.variants, c.sizes) == (6, {wks.VARIANT: 6}, {512: 1, 64: 2, 1: 3})
    assert [a["T"] for _, a in lib.calls] == [512, 64, 1, 64, 1, 1]


def test_the_meta_state_pass_counts_the_loops_arithmetic():
    """On the meta device ``ref.wkv6_state`` runs its T steps as one batched
    step (as ``ref.wkv6_scan`` does): the state of the loop's shape and
    dtype, the loop's (zero) matmul FLOPs, and a count of ops that does not
    grow with T."""
    BH, N, V = 3, 8, 16
    ops_by_T = {}
    for T in (7, 70):
        gen = torch.Generator().manual_seed(T)
        k = torch.randn((BH, T, N), generator=gen).to(torch.bfloat16)
        v = torch.randn((BH, T, V), generator=gen).to(torch.bfloat16)
        w = torch.randn((BH, T, N), generator=gen)
        s0 = torch.randn((BH, N, V), generator=gen)
        counts = {}
        for dev in ("cpu", "meta"):
            count = dryrun.MetaCount()
            with count:
                state = ref.wkv6_state(k.to(dev), v.to(dev), w.to(dev), s0.to(dev))
            assert state.shape == (BH, N, V) and state.dtype == torch.float32
            counts[dev] = count
        assert counts["cpu"].flops == counts["meta"].flops == 0
        assert counts["cpu"].ops > T
        ops_by_T[T] = counts["meta"].ops
    assert ops_by_T[7] == ops_by_T[70]


def test_the_meta_prefill_runs_the_state_pass():
    """A bf16 prefill on the meta device (the dry run's) calls the state
    pass's plain version once a layer beside the scan, as on the CPU."""
    cfg = dataclasses.replace(smoke_variant(get_config("rwkv6-1.6b")), dtype="bfloat16")
    model = build_model(cfg, device="meta")
    params = model.init(torch.Generator())
    tokens = torch.zeros((2, 40), dtype=torch.long, device="meta")
    ops.reset_counters()
    with torch.no_grad():
        logits, caches = model.forward_prefill(params, tokens, 64)
    assert logits.device.type == "meta" and caches["wkv"][0].dtype == torch.float32
    assert ops.COUNTERS["wkv6_scan"].plain_calls == cfg.num_layers
    assert ops.COUNTERS["wkv6_state"].plain_calls == cfg.num_layers
