"""Mamba2's SSD mixer as kernels (``kernels/ssd.py``): the plain versions
against the JAX package, the wrappers' rules, routing and counters, and P8.

On the CPU the kernels cannot run; what runs is their plain versions
(``ref.ssd_scan``, ``ref.ssd_step``), held against the reference's jnp on
seeded numpy inputs: the scan at chunks 16 and 64 (64 is the kernel's own),
S from 1 to 300, from zero and from a given state; the decode mixer over 3
steps at R = B = 2, the caches going in and coming back out. Float32 at
rtol/atol 1e-4 (``test_torch_ssm.py``'s); bf16 no farther from the float32
result than twice the reference's bf16 result is, plus 0.1% of its largest
magnitude (the port's bf16 rule). Also: the rounding gap between the
model's chunk (256) and the kernel's (64) against a float64 recurrence,
which ``chip_smoke.py``'s ``SSD_SCAN_ATOL_OF_MAX`` must cover; a numpy
emulation of the mma kernel's 3xTF32 products in the chunked form against
the same recurrence (single-pass TF32 printed beside it); the wrappers'
fixed rules (chunk, strips, shared memory, grids, scratch, the gradient
route, the variant codes) and refusals before any launch; the ops' routes
by device and their counters; and ``_causal_conv`` (P8) against the JAX
conv with ``F.conv1d`` unusable.
"""

import contextlib
import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.config import get_config as jget_config  # noqa: E402
from repro.config import smoke_variant as jsmoke  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402

from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import _build, ops, ref, ssd  # noqa: E402
from repro_torch.models import build_model, ssm  # noqa: E402

RTOL = ATOL = 1e-4
CSRC = Path(ssd.__file__).resolve().parent / "csrc"
# csrc/ssd_step.cu's block: state threads, threads, 16-byte state vectors a
# thread, vectors a state row
STEP_BLOCK = {"kStateThreads": 256, "kThreads": 288, "kVecs": 4, "kRowVecs": 16}


def _randn(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _bf16(a):
    """a rounded to bf16 and back, as numpy float32 (the values both sides get)."""
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=RTOL, atol=ATOL)


def _twice_the_reference(got, want_bf16, want_f32):
    """The port's bf16 result no farther from the float32 one than twice
    the reference's bf16 result is, plus 0.1% of its largest magnitude."""
    got, want_bf16, want_f32 = (np.asarray(a, np.float64) for a in (got, want_bf16, want_f32))
    e_port = np.abs(got - want_f32).max()
    e_ref = np.abs(want_bf16 - want_f32).max()
    assert e_port <= 2 * e_ref + 1e-3 * np.abs(want_f32).max(), (e_port, e_ref)


def _scan_inputs(rng, S, with_state, B=2, H=3, P=8, N=4):
    xh = _randn(rng, B, S, H, P)
    dt = np.log1p(np.exp(_randn(rng, B, S, H)))  # softplus: positive steps
    A = -np.linspace(0.5, 4.0, H).astype(np.float32)
    Bm, Cm = _randn(rng, B, S, N), _randn(rng, B, S, N)
    s0 = _randn(rng, B, H, P, N) if with_state else None
    return (xh, dt, A, Bm, Cm), s0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zero_state", "given_state"])
@pytest.mark.parametrize("S", [1, 5, 37, 64, 300])
@pytest.mark.parametrize("chunk", [16, 64])
def test_plain_scan_matches_jax(chunk, S, with_state, dtype):
    rng = np.random.RandomState(S * 4 + chunk + with_state)
    (xh, dt, A, Bm, Cm), s0 = _scan_inputs(rng, S, with_state)
    if dtype == "bfloat16":  # xh, B and C in the model dtype, dt and A float32
        xh, Bm, Cm = _bf16(xh), _bf16(Bm), _bf16(Cm)
    tdt, jdt = getattr(torch, dtype), getattr(jnp, dtype)
    y, state = ref.ssd_scan(torch.from_numpy(xh).to(tdt), torch.from_numpy(dt),
                            torch.from_numpy(A), torch.from_numpy(Bm).to(tdt),
                            torch.from_numpy(Cm).to(tdt), chunk,
                            None if s0 is None else torch.from_numpy(s0))
    assert y.shape == xh.shape and y.dtype == tdt and state.dtype == torch.float32

    def jscan(dt_):
        return jssm.ssd_scan(jnp.asarray(xh, dt_), jnp.asarray(dt), jnp.asarray(A),
                             jnp.asarray(Bm, dt_), jnp.asarray(Cm, dt_), chunk,
                             init_state=None if s0 is None else jnp.asarray(s0))
    jy32, js32 = jscan(jnp.float32)
    _close(state.numpy(), js32)  # the state is float32 from the same values either way
    if dtype == "float32":
        _close(y.numpy(), jy32)
    else:
        jy16, _ = jscan(jdt)
        _twice_the_reference(y.float().numpy(), np.asarray(jy16, np.float32), jy32)


def _recurrence64(xh, dt, A, Bm, Cm):
    """The SSD recurrence step by step in float64, from zero: y (B, S, H, P)."""
    B, S, H, P = xh.shape
    st = np.zeros((B, H, P, Bm.shape[-1]))
    ys = []
    for t in range(S):
        d = np.exp(dt[:, t].astype(np.float64) * A)
        st = d[..., None, None] * st + (dt[:, t, :, None] * xh[:, t])[..., None] \
            * Bm[:, t, None, None, :]
        ys.append(np.einsum("bhpn,bn->bhp", st, Cm[:, t]))
    return np.stack(ys, 1)


def test_the_kernel_chunk_rounds_no_worse_than_the_model_chunk():
    """zamba2's decays (A = -linspace(1, 16)) over a 777-step prompt: the
    plain scan at the model's chunk (256) and at the kernel's (64) against
    a float64 recurrence. cum sums over 4x the steps at 256, so its
    exp(cum_l - cum_m) rounds worse; each is within a fraction of
    ``chip_smoke.SSD_SCAN_ATOL_OF_MAX`` of the largest |y|, so the tolerance
    the card holds the kernel to covers the two chunks' difference."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    rng = np.random.RandomState(0)
    B, S, H, P, N = 1, 777, 8, 8, 16
    xh = _randn(rng, B, S, H, P)
    dt = np.log1p(np.exp(_randn(rng, B, S, H)))
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm, Cm = _randn(rng, B, S, N, scale=0.5), _randn(rng, B, S, N, scale=0.5)
    want = _recurrence64(xh, dt, A, Bm, Cm)
    scale = np.abs(want).max()
    errs = {}
    for chunk in (get_config("zamba2-7b").ssm.chunk_size, ssd.CHUNK):
        y, _ = ref.ssd_scan(*(torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm)), chunk)
        errs[chunk] = np.abs(y.numpy().astype(np.float64) - want).max() / scale
    print(f"max |y - float64| / max |y|: {errs}")
    assert errs[ssd.CHUNK] <= errs[256]
    assert errs[256] + errs[ssd.CHUNK] <= chip_smoke.SSD_SCAN_ATOL_OF_MAX / 2


def _tf32(a, rounded=True):
    """float32 ``a`` as TF32 (10 stored mantissa bits), by mantissa masking:
    rounded to nearest, ties away from zero (the kernel's split of big: half
    of the dropped 13 bits added to the magnitude, then masked), or
    truncated (how the tensor core reads small = v - big: its low 13 bits
    ignored)."""
    u = np.ascontiguousarray(a, np.float32).view(np.uint32)
    if rounded:
        u = u + np.uint32(0x1000)
    return (u & np.uint32(0xffffe000)).view(np.float32)


def _tensor_core_product(a, b, passes):
    """a @ b in float32 as SSD-scan's mma kernel takes it on the tensor
    cores: ``passes`` 3 is 3xTF32 (big = tf32(v), small = v - big as TF32;
    a_small b_big + a_big b_small + a_big b_big, float32 sums). An operand
    exact in TF32 (a bf16 value) has a zero small part, so its product is
    the kernel's two passes (a_small b + a_big b) and a bf16 Gram is exact
    products. ``passes`` 1 is single-pass TF32 (a_big b_big)."""
    ab, bb = _tf32(a), _tf32(b)
    if passes == 1:
        return ab @ bb
    small_a, small_b = _tf32(a - ab, rounded=False), _tf32(b - bb, rounded=False)
    return small_a @ bb + ab @ small_b + ab @ bb


def _fast_exp(v):
    """float32 ``__expf(v)`` as the kernel's M takes it: ex2.approx of v
    log2(e), the product rounded to float32 (its dominant error: ~1e-6
    relative at |v| ~ 20); ex2.approx's own error (~2 ulp) is not modelled."""
    t = np.asarray(v, np.float32) * np.float32(1.4426950408889634)
    return np.exp2(t.astype(np.float64)).astype(np.float32)


def _chunked_on_tensor_cores(xh, dt, A, Bm, Cm, passes, L=64):
    """The mma kernel's chunked form in float32 from zero, every product as
    ``_tensor_core_product`` takes it and in the kernel's order: per chunk
    the Gram G = C B^T; M o dt = G o __expf(cum_l - cum_m) o dt_m at and
    below the diagonal, then y = (M o dt) x + exp(cum) o (C S^T), x
    exact in a bf16 model (two passes); S = exp(last) S + (exp(last - cum)
    o (x dt))^T B, B exact in a bf16 model."""
    Bsz, S, H, P = xh.shape
    f32 = np.float32
    y = np.zeros(xh.shape, f32)
    for b in range(Bsz):
        for h in range(H):
            st = np.zeros((P, Bm.shape[-1]), f32)
            for c0 in range(0, S, L):
                sl = slice(c0, min(c0 + L, S))
                d = dt[b, sl, h]
                cum = np.cumsum(d * A[h], dtype=f32)
                C, Bc, x = Cm[b, sl], Bm[b, sl], xh[b, sl, h]
                G = _tensor_core_product(C, Bc.T, passes)
                low = np.tril(np.ones(G.shape, bool))
                Mdt = np.where(low, G * _fast_exp(np.where(low, cum[:, None] - cum[None, :], 0))
                               * d[None, :], 0).astype(f32)
                y[b, sl, h] = (_tensor_core_product(Mdt, x, passes)
                               + np.exp(cum)[:, None] * _tensor_core_product(C, st.T, passes))
                last = cum[-1]
                xw = (np.exp(last - cum)[:, None] * (x * d[:, None])).astype(f32)
                st = (np.exp(last) * st + _tensor_core_product(xw.T, Bc, passes)).astype(f32)
    return y


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_the_kernels_3xtf32_products_hold_the_float32_check(dtype):
    """zamba2's decays (A = -linspace(1, 16)) over a 777-step prompt at the
    kernel's N = 64: the mma kernel's chunked form with its 3xTF32 products
    is within half of ``chip_smoke.SSD_SCAN_ATOL_OF_MAX`` of the largest |y|
    from a float64 recurrence (B, C and x as bf16 values in the bf16 case:
    the Gram's products exact). Single-pass TF32 products, printed beside
    it, are why the split is there."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    rng = np.random.RandomState(3)
    B, S, H, P, N = 1, 777, 8, 8, ssd.SUPPORTED["N"]
    xh = _randn(rng, B, S, H, P)
    dt = np.log1p(np.exp(_randn(rng, B, S, H)))
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    Bm, Cm = _randn(rng, B, S, N, scale=0.5), _randn(rng, B, S, N, scale=0.5)
    if dtype == "bfloat16":
        xh, Bm, Cm = _bf16(xh), _bf16(Bm), _bf16(Cm)
    want = _recurrence64(xh, dt, A, Bm, Cm)
    scale = np.abs(want).max()
    errs = {passes: np.abs(_chunked_on_tensor_cores(xh, dt, A, Bm, Cm, passes) - want).max()
            / scale for passes in (3, 1)}
    print(f"{dtype}: max |y - float64| / max |y|: 3xTF32 {errs[3]:.3e}, single-pass TF32 "
          f"{errs[1]:.3e} (the float32 check allows {chip_smoke.SSD_SCAN_ATOL_OF_MAX:.0e})")
    assert errs[3] <= chip_smoke.SSD_SCAN_ATOL_OF_MAX / 2
    assert errs[1] > errs[3]


def _step_params(cfg, seed, R):
    rng = np.random.RandomState(seed)
    d_inner, H, P, N = ssm.dims(cfg)
    W, d = cfg.ssm.conv_width, cfg.d_model

    def w(*shape, scale=None):
        return _randn(rng, R, *shape, scale=scale or 1.0 / np.sqrt(shape[0]))

    return {
        "wz": w(d, d_inner), "wx": w(d, d_inner), "wB": w(d, N), "wC": w(d, N),
        "wdt": w(d, H), "conv_x_w": w(W, d_inner, scale=0.3), "conv_x_b": w(d_inner, scale=0.1),
        "conv_B_w": w(W, N, scale=0.3), "conv_B_b": w(N, scale=0.1),
        "conv_C_w": w(W, N, scale=0.3), "conv_C_b": w(N, scale=0.1),
        "A_log": np.broadcast_to(np.log(np.linspace(1.0, 16.0, H)), (R, H))
        .astype(np.float32).copy(),
        "D": 1.0 + w(H, scale=0.2), "dt_bias": w(H, scale=0.5),
        "norm": 1.0 + w(d_inner, scale=0.1), "out_proj": w(d_inner, d),
    }


def _configs():
    t = smoke_variant(get_config("zamba2-7b"), d_model=64)
    j = jsmoke(jget_config("zamba2-7b"), d_model=64)
    return t, j


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_step_matches_jax_decode_over_three_steps(dtype):
    """R = 2 tenants x B = 2 slots, seeded caches: ``ref.ssd_step`` (then
    ``out_proj``) against the reference's ``mamba2_decode`` per tenant, each
    step's caches going into the next; float32 at 1e-4, bf16 by the
    twice-the-reference rule against the reference in float32."""
    tcfg, jcfg = _configs()
    R, B = 2, 2
    d_inner, H, P, N = ssm.dims(tcfg)
    W = tcfg.ssm.conv_width
    p = _step_params(tcfg, 8, R)
    rng = np.random.RandomState(9)
    cache = {"conv_x": _randn(rng, R, B, W - 1, d_inner), "conv_B": _randn(rng, R, B, W - 1, N),
             "conv_C": _randn(rng, R, B, W - 1, N), "ssm": _randn(rng, R, B, H, P, N)}
    lowp = {"float32", "ssm", "A_log", "D", "dt_bias"}
    if dtype == "bfloat16":  # everything but the state and the float32 params in bf16
        p = {k: v if k in lowp else _bf16(v) for k, v in p.items()}
        cache = {k: v if k in lowp else _bf16(v) for k, v in cache.items()}
    tdt = getattr(torch, dtype)
    tp = {k: torch.from_numpy(v).to(tdt if k not in lowp else torch.float32)
          for k, v in p.items()}
    # copies: the step updates its caches in place, and jnp.asarray may share numpy's memory
    tcache = {k: torch.from_numpy(v.copy()).to(tdt if k not in lowp else torch.float32)
              for k, v in cache.items()}
    jcaches = {
        dt_: [{k: jnp.asarray(v[r], jnp.float32 if k == "ssm" else dt_) for k, v in cache.items()}
              for r in range(R)] for dt_ in (jnp.float32, getattr(jnp, dtype))}
    jcfg32 = dataclasses.replace(jcfg, dtype="float32")
    for _ in range(3):
        x = _randn(rng, R, B, tcfg.d_model)
        if dtype == "bfloat16":
            x = _bf16(x)
        xt = torch.from_numpy(x).to(tdt)
        z, xs, Bm, Cm, dt = (torch.matmul(xt, tp[k]) for k in ("wz", "wx", "wB", "wC", "wdt"))
        y = ref.ssd_step(tp, tcache, z, xs, Bm, Cm, dt)
        assert y.shape == (R, B, d_inner) and y.dtype == tdt
        out = torch.matmul(y, tp["out_proj"]).float().numpy()
        for r in range(R):
            jouts = {}
            for dt_ in jcaches:
                pr = {k: jnp.asarray(v[r], jnp.float32 if k in lowp else dt_)
                      for k, v in p.items()}
                cfg_ = jcfg32 if dt_ == jnp.float32 else dataclasses.replace(jcfg, dtype=dtype)
                jy, jcaches[dt_][r] = jssm.mamba2_decode(pr, jnp.asarray(x[r][:, None], dt_),
                                                         cfg_, jcaches[dt_][r])
                jouts[dt_] = np.asarray(jy[:, 0], np.float32)
            if dtype == "float32":
                _close(out[r], jouts[jnp.float32])
                for k in ssm.CACHE_NAMES:
                    _close(tcache[k][r].numpy(), jcaches[jnp.float32][r][k])
            else:
                _twice_the_reference(out[r], jouts[jnp.bfloat16], jouts[jnp.float32])
                for k in ("conv_x", "conv_B", "conv_C"):  # the shifted windows: the same values
                    np.testing.assert_array_equal(
                        tcache[k][r].float().numpy(),
                        np.asarray(jcaches[jnp.bfloat16][r][k], np.float32))
                _twice_the_reference(tcache["ssm"][r].numpy(), jcaches[jnp.bfloat16][r]["ssm"],
                                     jcaches[jnp.float32][r]["ssm"])


def test_the_rules_mirror_the_kernel_sources():
    scan = (CSRC / "ssd_scan.cu").read_text()
    step = (CSRC / "ssd_step.cu").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert const(scan, "kL") == ssd.CHUNK == 64  # every S: the last chunk is masked
    assert const(scan, "kPS") == ssd.P_SLICE
    assert const(scan, "kTile") == ssd.TILE == 16  # a warp's strip: m16 of mma.sync
    assert const(scan, "kRowS") == ssd.SUPPORTED["N"] + 8
    assert const(scan, "kSmemBf16") == ssd.scan_smem_bytes(torch.bfloat16)
    assert const(scan, "kSmemF32") == ssd.scan_smem_bytes(torch.float32)
    assert "__launch_bounds__(kThreads, 2) ssd_scan_kernel" in scan  # <= 128 registers
    # the mma kernel's products: a bf16 Gram, 3xTF32 (big rounded by mantissa
    # masking, as _tf32 emulates it), no library call
    for op in ("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32",
               "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32",
               "(__float_as_uint(v) + 0x1000u) & 0xffffe000u"):
        assert op in scan
    assert "cublas" not in scan.lower()
    assert "variant: 0 cuda_core, 1 mma" in scan
    assert ssd.SCAN_VARIANT_CODES == {"cuda_core": 0, "mma": 1} and ssd.SCAN_VARIANT == "mma"
    assert const(scan, "kN") == const(step, "kN") == ssd.SUPPORTED["N"]
    assert const(step, "kP") == ssd.SUPPORTED["P"] and const(step, "kW") == ssd.SUPPORTED["W"]
    for name in ("ssd_scan", "ssd_step"):
        assert name in _build.SOURCES and name in _build.SIGNATURES
    # SSD-step's block: 8 state warps of 4 16-byte vectors a thread (16 a
    # row) and warp 8 for the shared B and C windows; the state streamed
    # with an evict-first hint; no memset and no scratch made by the launch;
    # the sequence's last arriving block shifts the windows and resets its
    # counter; no library call
    env = {}
    for name, expr in re.findall(r"constexpr int (\w+) = ([^;]+);", step):
        env[name] = int(eval(expr.replace("/", "//"), {}, dict(env)))
    assert {name: env[name] for name in STEP_BLOCK} == STEP_BLOCK
    assert env["kVecs"] * env["kStateThreads"] * 4 == ssd.SUPPORTED["P"] * ssd.SUPPORTED["N"]
    assert "__ldcs(st + kStateThreads * q)" in step and "__stcs(st + kStateThreads * q, v)" in step
    assert "Memset" not in step and "cudaMalloc" not in step and "cublas" not in step.lower()
    for rule in ("atomicAdd(a.arrivals + rb, 1u)", "== (unsigned)H - 1",
                 "a.arrivals[rb] = 0u", "named_arrive(1, kThreads)"):
        assert rule in step, rule
    assert ssd.STEP_VARIANT == "coalesced"


def test_grids_and_scratch():
    cfg = get_config("zamba2-7b")
    _, H, P, N = ssm.dims(cfg)
    assert (H, P, N, cfg.ssm.conv_width) == (112, 64, 64, 4)
    assert ssd.SUPPORTED == {"P": P, "N": N, "W": cfg.ssm.conv_width}
    assert ssd.scan_grid(1, H, P) == 224  # one prefill sequence: more blocks than 132 SMs
    # ... and one wave of them: blocks an SM by shared memory (228 KB an SM,
    # 1 KB of it reserved a block), at most 2 by registers (256 threads at
    # __launch_bounds__(256, 2)), times 132 SMs
    for dtype in (torch.bfloat16, torch.float32):
        by_smem = (228 * 1024) // (ssd.scan_smem_bytes(dtype) + 1024)
        assert 132 * min(by_smem, 2) >= ssd.scan_grid(1, H, P), dtype
    # strips of TILE rows the mma kernel computes: a 1- to 16-token piece is one
    assert [ssd.scan_tiles(S) for S in (1, 4, 16, 17, 64, 128, 512, 742, 777)] == [
        (1, 1), (1, 1), (1, 1), (1, 2), (1, 4), (2, 4), (8, 4), (12, 3), (13, 1)]
    assert ssd.step_grid(4, 4, H) == 1792 and ssd.step_grid(1, 4, H) == 448
    assert ssd.step_work_ints(4, 4) == 16 and ssd.step_work_ints(1, 4) == 4
    # the step's counters: kept with the state, zeroed once, one set a state
    # (and a sequence count), never made per launch
    state = torch.zeros(4, 4, 2, 64, 64)
    counters = ssd.step_arrivals(state, 4, 4)
    assert counters.dtype == torch.int32 and counters.shape == (16,) and not counters.any()
    assert ssd.step_arrivals(state, 4, 4) is counters
    counters[3] = 7  # whatever a launch leaves is what the next one finds
    assert int(ssd.step_arrivals(state, 4, 4)[3]) == 7
    counters.zero_()
    assert ssd.step_arrivals(torch.zeros_like(state), 4, 4) is not counters
    tenant0 = state[:1]  # one tenant's view: the same address, other sequences
    assert tenant0.data_ptr() == state.data_ptr()
    assert ssd.step_arrivals(tenant0, 1, 4) is not counters
    assert ssd.step_arrivals(tenant0, 1, 4).shape == (4,)


def test_the_arrival_counters_live_as_long_as_their_state():
    """A counter set is dropped once its state's storage is freed (when the
    next new set is made), so states made and freed one after another, as
    a server's prefills hand decode fresh ones, leave no sets behind; a
    tenant's view keeps its set while the whole state lives."""
    import gc

    def sets():
        return sum(1 for state, _ in ssd._ARRIVALS.values() if not state.expired())

    before = len(ssd._ARRIVALS)
    state = torch.zeros(2, 3, 2, 64, 64)
    kept = ssd.step_arrivals(state[1:], 1, 3)
    live = sets()
    for _ in range(20):
        ssd.step_arrivals(torch.zeros(1, 3, 2, 64, 64), 1, 3)
        gc.collect()
    assert sets() == live and len(ssd._ARRIVALS) <= before + 2
    assert ssd.step_arrivals(state[1:], 1, 3) is kept
    key = (state.device, state[1:].data_ptr(), 3)
    del state, kept
    gc.collect()
    assert ssd._ARRIVALS[key][0].expired()
    ssd.step_arrivals(torch.zeros(1, 3, 2, 64, 64), 1, 3)
    assert key not in ssd._ARRIVALS


def test_the_scan_route_raises_on_a_gradient_on_the_card():
    assert ssd.scan_route(False, False) == ssd.scan_route(False, True) == "plain"
    assert ssd.scan_route(True, False) == "kernel"
    with pytest.raises(NotImplementedError, match="no backward kernel"):
        ssd.scan_route(True, True)


def _cuda_like(monkeypatch):
    """The device check passed for CPU tensors; loading the library fails,
    so a test sees whether the wrapper got as far as the launch."""
    monkeypatch.setattr(_build, "check_device", lambda t: None)

    def no_launch(name):
        raise AssertionError("reached the launch")
    monkeypatch.setattr(_build, "load", no_launch)


def _full_width_scan(S=5, P=64, N=64, dtype=torch.bfloat16):
    H = 2
    return (torch.zeros(1, S, H, P, dtype=dtype), torch.ones(1, S, H), -torch.ones(H),
            torch.zeros(1, S, N, dtype=dtype), torch.zeros(1, S, N, dtype=dtype))


def test_the_scan_wrapper_refuses_before_the_launch(monkeypatch):
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd.ssd_scan(*_full_width_scan())
    _cuda_like(monkeypatch)
    with pytest.raises(ValueError, match="the kernel takes"):
        ssd.ssd_scan(*_full_width_scan(P=32))
    with pytest.raises(ValueError, match="the kernel takes"):
        ssd.ssd_scan(*_full_width_scan(N=16))
    with pytest.raises(TypeError, match="dtype"):
        ssd.ssd_scan(*_full_width_scan(dtype=torch.float16))
    xh, dt, A, Bm, Cm = _full_width_scan()
    with pytest.raises(TypeError, match="float32"):
        ssd.ssd_scan(xh, dt.to(torch.bfloat16), A, Bm, Cm)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd_scan(xh, dt, A, Bm.transpose(1, 2).contiguous().transpose(1, 2), Cm)
    with pytest.raises(ValueError, match="init_state"):
        ssd.ssd_scan(xh, dt, A, Bm, Cm, torch.zeros(1, 2, 64, 32))
    with pytest.raises(AssertionError, match="reached the launch"):
        ssd.ssd_scan(xh, dt, A, Bm, Cm, torch.zeros(1, 2, 64, 64))


def test_the_scan_wrapper_launches_the_kernel_it_is_asked_for(monkeypatch):
    """Through a stand-in library: ``ssd_scan`` launches ``SCAN_VARIANT``'s
    code (mma, 1) and ``scan_prior`` cuda_core's (0), each counted under its
    name."""
    import contextlib

    calls = []

    class Lib:
        def repro_ssd_scan(self, *args):
            calls.append(args)
            return 0
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    monkeypatch.setattr(_build, "load", lambda name: Lib())
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    ssd.scan_counter.reset()
    y, state = ssd.ssd_scan(*_full_width_scan())
    assert y.dtype == torch.bfloat16 and state.shape == (1, 2, 64, 64)
    ssd.scan_prior(*_full_width_scan(dtype=torch.float32))
    assert [c[-3:-1] for c in calls] == [(1, 1), (0, 0)]  # (dtype, variant) codes
    assert ssd.scan_counter.variants == {"mma": 1, "cuda_core": 1}
    ssd.scan_counter.reset()


def test_the_scan_bound_prices_the_tensor_core_products():
    """``chip_smoke.ssd_scan_bound`` comes from the inputs alone: the
    recurrence's 4 S H P N operations at the TF32 rate over the kernel's
    passes (2 in a bf16 model, 3 in float32) against its bytes; the CUDA
    cores' term is reported beside it, never the bound."""
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke

    for dtype, passes in (("torch.bfloat16", 2), ("torch.float32", 3)):
        for S, state in ((1, True), (64, True), (512, True), (742, False)):
            nbytes, flops = chip_smoke.ssd_scan_work(S, state, dtype)
            bound_ms, by, bytes_ms, ops_ms, cuda_core_ms = chip_smoke.ssd_scan_bound(
                S, state, dtype)
            assert ops_ms == pytest.approx(flops * passes / 495e12 * 1e3)
            assert cuda_core_ms == pytest.approx(flops / 67e12 * 1e3) and cuda_core_ms > ops_ms
            assert bytes_ms == pytest.approx(nbytes / 3.35e12 * 1e3)
            assert bound_ms == max(bytes_ms, ops_ms)
            assert by == ("bytes" if bytes_ms >= ops_ms else "operations")
    # zamba2's bf16 512-token piece: bytes-bound once the products are on
    # the tensor cores
    assert chip_smoke.ssd_scan_bound(512, True, "torch.bfloat16")[1] == "bytes"


def _step_inputs(R=2, B=2, H=2, P=64, N=64, W=4, dtype=torch.bfloat16):
    d = H * P
    f32 = torch.float32
    p = {"conv_x_w": torch.zeros(R, W, d, dtype=dtype), "conv_x_b": torch.zeros(R, d, dtype=dtype),
         "conv_B_w": torch.zeros(R, W, N, dtype=dtype), "conv_B_b": torch.zeros(R, N, dtype=dtype),
         "conv_C_w": torch.zeros(R, W, N, dtype=dtype), "conv_C_b": torch.zeros(R, N, dtype=dtype),
         "A_log": torch.zeros(R, H), "D": torch.ones(R, H), "dt_bias": torch.zeros(R, H),
         "norm": torch.ones(R, d, dtype=dtype)}
    cache = {"conv_x": torch.zeros(R, B, W - 1, d, dtype=dtype),
             "conv_B": torch.zeros(R, B, W - 1, N, dtype=dtype),
             "conv_C": torch.zeros(R, B, W - 1, N, dtype=dtype),
             "ssm": torch.zeros(R, B, H, P, N, dtype=f32)}
    proj = (torch.zeros(R, B, d, dtype=dtype), torch.zeros(R, B, d, dtype=dtype),
            torch.zeros(R, B, N, dtype=dtype), torch.zeros(R, B, N, dtype=dtype),
            torch.zeros(R, B, H, dtype=dtype))
    return p, cache, proj


def test_the_step_wrapper_refuses_before_the_launch(monkeypatch):
    p, cache, proj = _step_inputs()
    with pytest.raises(ValueError, match="CUDA tensor"):
        ssd.ssd_step(p, cache, *proj)
    _cuda_like(monkeypatch)
    for kwargs in ({"P": 32}, {"N": 16}, {"W": 3}):
        with pytest.raises(ValueError, match="the kernel takes"):
            ssd.ssd_step(*_step_inputs(**kwargs)[:2], *_step_inputs(**kwargs)[2])
    bad = dict(cache, ssm=cache["ssm"].to(torch.bfloat16))
    with pytest.raises(TypeError, match="ssm"):
        ssd.ssd_step(p, bad, *proj)
    strided = dict(cache, conv_B=cache["conv_B"].transpose(2, 3).contiguous().transpose(2, 3))
    with pytest.raises(ValueError, match="conv_B"):
        ssd.ssd_step(p, strided, *proj)
    with pytest.raises(TypeError, match="D"):
        ssd.ssd_step(dict(p, D=p["D"].to(torch.bfloat16)), cache, *proj)
    with pytest.raises(AssertionError, match="reached the launch"):
        ssd.ssd_step(p, cache, *proj)


def test_the_step_launch_makes_no_scratch_and_no_memset(monkeypatch):
    """The wrapper hands the kernel the counters kept with the state: the
    same ones launch after launch on one cache, others for another cache,
    and a launch after the first allocates nothing but y (the library call
    stood in for; the C side zeroes nothing, as the source check shows)."""
    calls = []

    class Lib:
        @staticmethod
        def repro_ssd_step(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(_build, "check_device", lambda t: None)
    monkeypatch.setattr(_build, "load", lambda name: Lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    p, cache, proj = _step_inputs(R=2, B=3, H=2)
    other = {k: v.clone() for k, v in cache.items()}
    ssd.ssd_step(p, cache, *proj)
    made = []
    for name in ("empty", "zeros", "full"):
        real = getattr(torch, name)
        monkeypatch.setattr(torch, name, lambda *a, _real=real, _n=name, **k: (
            made.append(_n), _real(*a, **k))[1])
    y = ssd.ssd_step(p, cache, *proj)
    assert made == [] and y.shape == (2, 3, 128)
    ssd.ssd_step(p, other, *proj)
    assert made == ["zeros"]  # the other state's counters, once
    first, second, third = calls
    assert first[20] == second[20] == ssd.step_arrivals(cache["ssm"], 2, 3).data_ptr()
    assert third[20] == ssd.step_arrivals(other["ssm"], 2, 3).data_ptr() != first[20]
    assert first[21:28] == (2, 3, 2, 64, 64, 4, _build.DTYPE_CODES[torch.bfloat16])
    assert len(first) == len(_build.SIGNATURES["ssd_step"][0])


def _emulated_launch(counters, H, orders):
    """One SSD-step launch's arrivals as the kernel makes them: in sequence
    rb, block h's warp 8 adds 1 to ``counters[rb]`` in the order
    ``orders[rb]``; the block that finds H - 1 is the last, shifts the B
    and C windows and writes 0. Returns, by sequence, the blocks that
    shifted."""
    shifted = []
    for rb, order in enumerate(orders):
        last = []
        for h in order:
            old = counters[rb]
            counters[rb] = old + 1
            if old == H - 1:
                last.append(h)
                counters[rb] = 0
        shifted.append(last)
    return shifted


def test_the_arrival_counters_stay_right_over_successive_launches():
    """The counters' arithmetic over 6 launches of 4 sequences, blocks
    arriving in a new random order each launch: from counters made at 0,
    exactly one block a sequence shifts, the H-th to arrive, after every
    head has read, and each launch leaves every counter at 0 for the next.
    Left stale at H (chip_smoke.py's control), no block shifts and the
    counters stay off, launch after launch."""
    H, seqs = 112, 4
    rng = np.random.RandomState(0)
    counters = ssd.step_arrivals(torch.zeros(1, seqs, 1, 64, 64), 1, seqs).tolist()
    assert counters == [0] * seqs
    for _ in range(6):
        orders = [rng.permutation(H).tolist() for _ in range(seqs)]
        shifted = _emulated_launch(counters, H, orders)
        assert shifted == [[order[-1]] for order in orders]
        assert counters == [0] * seqs
    stale = [H] * seqs
    for _ in range(3):
        assert _emulated_launch(stale, H, [rng.permutation(H).tolist()
                                           for _ in range(seqs)]) == [[]] * seqs
    assert stale == [H + 3 * H] * seqs


def test_the_coalesced_tile_matches_the_plain_step():
    """The kernel's layout and sums for one head, emulated in float32 on the
    plain step's own conv outputs and dt: thread t of the 256 state
    threads owns the 16-byte vectors t + 256 q (rows t / 16 + 16 q, columns
    4 (t % 16) .. + 3), every vector once; the new state, two products and
    a sum, equals the plain version's bit for bit; y (a row's 4-column FMA
    chains, the pairwise tree over its 16 threads, D x, the gate, the
    norm's warp-then-block order) within float32 rounding of it."""
    rng = np.random.RandomState(3)
    H, P, N = 2, 64, 64
    p, cache, proj = _step_inputs(R=1, B=1, H=H, dtype=torch.float32)
    for t in (*p.values(), *cache.values(), *proj):
        t.copy_(torch.from_numpy(rng.standard_normal(tuple(t.shape)).astype(np.float32) * 0.5))
    p["A_log"].copy_(torch.log(torch.linspace(1.0, 16.0, H))[None])
    p["norm"].add_(1.0)
    s0 = cache["ssm"].clone()
    conv = {k: cache[k].clone() for k in ("conv_x", "conv_B", "conv_C")}
    want_y = ref.ssd_step(p, cache, *proj)
    z, xs, Bm, Cm, dt_raw = proj

    def conv_out(name, new):  # the plain version's conv output for this step
        window = torch.cat([conv[name], new[:, :, None, :]], dim=2)
        out = (window * p[f"{name}_w"][:, None]).sum(dim=2) + p[f"{name}_b"][:, None]
        return torch.nn.functional.silu(out)[0, 0].numpy()

    xc, Bc, Cc = conv_out("conv_x", xs), conv_out("conv_B", Bm), conv_out("conv_C", Cm)
    dts = torch.nn.functional.softplus(dt_raw + p["dt_bias"][:, None])  # as the plain step
    decay = torch.exp(dts * -torch.exp(p["A_log"])[:, None])[0, 0].numpy()
    dts = dts[0, 0].numpy()
    sz = torch.nn.functional.silu(z[0, 0]).numpy()
    t = np.arange(256)
    f = np.arange(4)[:, None] * 256 + t[None]           # (q, t): the vectors a thread owns
    rows, n0 = f // 16, (f % 16) * 4
    assert sorted(f.ravel().tolist()) == list(range(P * N // 4))
    f32 = np.float32
    for h in range(H):
        S = s0[0, 0, h].numpy()
        xh = xc[h * P:(h + 1) * P]
        coef = f32(dts[h]) * xh                          # (P,)
        cols = n0[..., None] + np.arange(4)              # (q, t, 4)
        old = S[rows[..., None], cols]
        new = f32(decay[h]) * old + coef[rows][..., None] * Bc[cols]
        got_S = np.empty_like(S)
        got_S[rows[..., None], cols] = new
        np.testing.assert_array_equal(got_S, cache["ssm"][0, 0, h].numpy())
        part = np.zeros(rows.shape, np.float32)          # fmaf over the 4 columns, in order
        for c in range(4):
            part = (new[..., c].astype(np.float64) * Cc[cols[..., c]] + part).astype(f32)
        lanes = part.reshape(4, 16, 16)                  # (q, row of the q, its 16 threads)
        for _ in range(4):                               # xor 1, 2, 4, 8: pairwise in lane order
            lanes = (lanes[..., 0::2] + lanes[..., 1::2]).astype(f32)
        y_rows = lanes[..., 0].ravel()                   # row 16 q + r, q-major: row order
        gv = ((y_rows + f32(p["D"][0, h]) * xh).astype(f32) * sz[h * P:(h + 1) * P]).astype(f32)
        sq = np.zeros(16, np.float32)                    # (warp, lane 0 or 16)
        for q in range(4):
            sq = (sq + gv[16 * q:16 * q + 16] ** 2).astype(f32)
        warp = (sq[0::2] + sq[1::2]).astype(f32)
        total = f32(0)
        for w in range(8):
            total = f32(total + warp[w])
        inv = f32(1) / np.sqrt(f32(total / f32(P) + f32(ref.SSD_NORM_EPS)), dtype=f32)
        got_y = gv * inv * p["norm"][0, h * P:(h + 1) * P].numpy()
        np.testing.assert_allclose(got_y, want_y[0, 0, h * P:(h + 1) * P].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_routes_and_counters_on_the_cpu_and_meta():
    rng = np.random.RandomState(1)
    (xh, dt, A, Bm, Cm), s0 = _scan_inputs(rng, 9, True)
    args = [torch.from_numpy(a) for a in (xh, dt, A, Bm, Cm)]
    ops.reset_counters()
    y, st = ops.ssd_scan(*args, 4, init_state=torch.from_numpy(s0))
    y2, st2 = ops.ssd_scan_plain(*args, 4, init_state=torch.from_numpy(s0))
    assert torch.equal(y, y2) and torch.equal(st, st2)
    c = ops.COUNTERS["ssd_scan"]
    assert (c.launches, c.plain_calls, c.variants) == (0, 2, {})
    meta = [a.to("meta") for a in args]
    y, st = ops.ssd_scan(*meta, 4)
    assert y.device.type == "meta" and st.shape == (2, 3, 8, 4) and c.plain_calls == 3
    p, cache, proj = _step_inputs(R=1, B=2, P=8, N=4, dtype=torch.float32)
    y = ops.ssd_step(p, cache, *proj)
    ops.ssd_step_plain(p, cache, *proj)
    s = ops.COUNTERS["ssd_step"]
    assert y.shape == (1, 2, 16) and (s.launches, s.plain_calls) == (0, 2)
    with ops.capturing() as captured:
        ops.ssd_step(p, cache, *proj)
    assert s.plain_calls == 2 and captured["ssd_step"].plain_calls == 1
    ops.replayed(captured, 3)
    assert s.plain_calls == 5
    ops.reset_counters()


def test_the_model_counts_its_plain_calls_and_trains_by_the_plain_scan():
    """A smoke zamba2 (4 layers, 2 of them Mamba2): a prefill and a decode
    step each call the SSD op once a Mamba2 layer, and the train forward
    the plain scan (SSD-scan has no backward kernel)."""
    cfg = smoke_variant(get_config("zamba2-7b"), num_layers=4)
    n_mamba = sum(k.name == "MAMBA2" for k in cfg.layer_pattern)
    assert n_mamba == 2
    model = build_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    tok = torch.randint(0, cfg.vocab_size, (1, 10), generator=gen)
    ops.reset_counters()
    with torch.no_grad():
        logits, caches = model.forward_prefill(params, tok, 32)
        model.forward_decode(params, tok[:, 0], caches, torch.tensor([10]))
    assert ops.COUNTERS["ssd_scan"].plain_calls == ops.COUNTERS["ssd_step"].plain_calls == n_mamba
    ops.reset_counters()
    loss, _ = model.forward_train(params, tok, tok)
    assert ops.COUNTERS["ssd_scan"].plain_calls == n_mamba
    assert ops.COUNTERS["ssd_step"].plain_calls == 0 and bool(torch.isfinite(loss))
    ops.reset_counters()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_without_cudnn_matches_jax(monkeypatch, dtype):
    """P8: the depthwise conv is float32 multiply-adds, no ``F.conv1d``
    (cuDNN, TF32 on the card by default): it runs with conv1d made to
    raise and matches the JAX conv at 1e-4 (bf16: the same rounding of a
    float32 result, within one bf16 step)."""
    import torch.nn.functional as F

    def no_conv(*a, **k):
        raise AssertionError("F.conv1d was called")
    monkeypatch.setattr(F, "conv1d", no_conv)
    rng = np.random.RandomState(2)
    x, w, b = _randn(rng, 2, 19, 12), _randn(rng, 4, 12), _randn(rng, 12)
    if dtype == "bfloat16":
        x, w, b = _bf16(x), _bf16(w), _bf16(b)
    tdt = getattr(torch, dtype)
    got = ssm._causal_conv(*(torch.from_numpy(a).to(tdt) for a in (x, w, b)))
    assert got.dtype == tdt and got.shape == x.shape
    want = jssm._causal_conv(*(jnp.asarray(a, getattr(jnp, dtype)) for a in (x, w, b)))
    if dtype == "float32":
        _close(got.numpy(), want)
    else:
        np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                                   rtol=2 ** -7, atol=1e-6)


def test_the_model_hands_the_kernels_what_they_take(monkeypatch):
    """A zamba2-shaped model with the kernels' head (P 64, N 64, conv 4) at
    d_model 64: its prefill (whole, and a continuation) and its decode step
    reach both wrappers' launches, every tensor passing their checks
    (dtype, shape, contiguity, alignment), with the device check stood in
    for and the library load made to stop the call."""
    base = smoke_variant(get_config("zamba2-7b"), d_model=64, num_layers=2)
    cfg = dataclasses.replace(base, dtype="bfloat16", ssm=dataclasses.replace(
        base.ssm, head_dim=ssd.SUPPORTED["P"], state_dim=ssd.SUPPORTED["N"]))
    model = build_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    tok = torch.randint(1, cfg.vocab_size, (1, 9), generator=gen)
    with torch.no_grad():
        _, caches = model.forward_prefill(params, tok, 16)
    _cuda_like(monkeypatch)
    monkeypatch.setattr(ops, "ssd_scan", lambda xh, dt, A, Bm, Cm, chunk, init_state=None:
                        ssd.ssd_scan(xh, dt, A, Bm, Cm, init_state))
    monkeypatch.setattr(ops, "ssd_step", ssd.ssd_step)
    with torch.no_grad():
        for call in (lambda: model.forward_prefill(params, tok, 16),
                     lambda: model.forward_prefill(params, tok[:, :4], 16, caches=caches,
                                                   start=9),
                     lambda: model.forward_decode(params, tok[:, 0], caches, torch.tensor([9]))):
            with pytest.raises(AssertionError, match="reached the launch"):
                call()
