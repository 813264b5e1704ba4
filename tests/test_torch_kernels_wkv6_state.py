"""The port's state pass (K5-state, ``wkv6_state``) against the JAX
package's ``_wkv_final_state``.

The plain ``ref.wkv6_state`` follows the reference's op order, so it must
agree with it to float32 rounding (STATE_TOL). The kernel's segmented math
(segments from zero, per-row decay products, the ordered combine), emulated
here in torch, regroups the same sums: it is held to the JAX kernel test's
tolerance (WKV_TOL, also chip_smoke.py's for K5's state), which a state
rolled with w rounded to bf16 (ROADMAP F4) fails. The row-block kernel's
roll (each block of rows from its own k, w columns and all of v, a 64-step
tile at a time as one product), emulated likewise, is held to the same
tolerance.
The rest covers the segment and variant rules, the row-block grid, the
wrapper's refusal of CPU tensors, the calls a prefill makes by dtype, and
the meta device's count.
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


def emulate_row_blocks(k, v, w, s0, R=wks.ROWS):
    """The row-block kernel's arithmetic in torch: each block of ``R`` state
    rows (a CTA) rolls from its rows of ``s0`` (None: zero), reading only
    its columns of k and w and all of v, a 64-step tile at a time as one
    product: S <- P S + sum_t k~_t v_t, k~_t = k_t m_t, with m_t the
    product of the decays after step t in the tile and P the tile's, both
    float32 as the kernel forms them; P S rounded to float32 and the
    tile's sum taken in float64 and added (the tensor cores' float32 sums
    of exact TF32 products, to within their rounding); the blocks are put
    together only at the end."""
    B, H, T, N = k.shape
    V = v.shape[-1]
    kf, vf = k.reshape(B * H, T, N).float(), v.reshape(B * H, T, V).float()
    decay = torch.exp(-torch.exp(w.reshape(B * H, T, N).float()))
    blocks = []
    for n0 in range(0, N, R):
        rows = slice(n0, min(N, n0 + R))
        S = (torch.zeros((B * H, rows.stop - n0, V)) if s0 is None else
             s0.reshape(B * H, N, V)[:, rows].clone())
        for t0 in range(0, T, wks.TILE):
            d = decay[:, t0:t0 + wks.TILE, rows]                        # (BH, nt, R)
            after = torch.cumprod(d.flip(1), dim=1).flip(1)            # prod over u >= t
            m = torch.cat([after[:, 1:], torch.ones_like(after[:, :1])], dim=1)
            kt = kf[:, t0:t0 + wks.TILE, rows] * m                      # k~, float32
            S = S * after[:, 0, :, None]                                # P S
            vt = vf[:, t0:t0 + wks.TILE]
            S = (S.double() + kt.double().transpose(1, 2) @ vt.double()).float()
        blocks.append(S)
    return torch.cat(blocks, dim=1)


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


def _inputs_f32(seed, B, H, T, N, V):
    """As ``_inputs`` with float32 k, v (not bf16 values)."""
    rng = np.random.RandomState(seed)
    k = (rng.standard_normal((B, T, H, N)) * 0.5).astype(np.float32)
    v = (rng.standard_normal((B, T, H, V)) * 0.5).astype(np.float32)
    w = rng.uniform(-8.0, 2.0, (B, T, H, N)).astype(np.float32)
    s0 = rng.standard_normal((B * H, N, V)).astype(np.float32)
    return k, v, w, s0


def _oracle_f32(k, v, w, s0):
    """The reference's ``_wkv_final_state`` on float32 k, v."""
    B, T, H = k.shape[:3]

    def heads(a):
        return jnp.asarray(a.transpose(0, 2, 1, 3).reshape(B * H, T, a.shape[-1]), jnp.float32)

    return np.asarray(_wkv_final_state(heads(k), heads(v), heads(w), jnp.asarray(s0)))


@pytest.mark.parametrize("N,V", [(64, 64), (16, 32), (8, 8)], ids=str)
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("T", (1, 4, 64, 512))
def test_the_row_block_roll_matches_the_reference(T, dtype, N, V):
    """The row-block kernel's roll at the graphed prefill's piece sizes 1, 4,
    64 and 512, from a random state, with decays that underflow, for bf16
    and float32 k, v: within WKV_TOL of ``_wkv_final_state`` and of the
    plain version. At N = 8 one block's rows past N get no CTA."""
    if dtype == "bfloat16":
        k, v, w, s0 = _inputs(T + N + V, 1, 3, T, N, V)
        views, want = _views(k, v, w), _oracle(k, v, w, s0)
    else:
        k, v, w, s0 = _inputs_f32(T + N + V, 1, 3, T, N, V)
        views = tuple(torch.from_numpy(a).transpose(1, 2) for a in (k, v, w))
        want = _oracle_f32(k, v, w, s0)
    got = emulate_row_blocks(*views, torch.from_numpy(s0)).numpy()
    assert _close(got, want, WKV_TOL), float(np.abs(got - want).max())
    plain = ref.wkv6_state(*views, torch.from_numpy(s0)).numpy()
    assert _close(got, plain, WKV_TOL)
    zero = emulate_row_blocks(*views, None).numpy()
    assert _close(zero, ref.wkv6_state(*views, None).numpy(), WKV_TOL)


def test_a_row_block_depends_on_its_own_rows_alone():
    """Row independence, what lets ``final_state`` be ``init_state`` with no
    ordering: changing one row of the incoming state, or k and w at one
    row, moves that row of the result and no other, bitwise."""
    k, v, w, s0 = _inputs(11, 1, 2, 64, 64, 64, w_low=-8.0, w_high=-5.0)  # slow decays
    kt, vt, wt = _views(k, v, w)
    base = emulate_row_blocks(kt, vt, wt, torch.from_numpy(s0))
    s1 = s0.copy()
    s1[1, 37] += 1.0
    moved = (emulate_row_blocks(kt, vt, wt, torch.from_numpy(s1)) != base).any(-1)
    assert moved.nonzero().tolist() == [[1, 37]]
    k2 = kt.clone()
    k2[0, 0, :, 20] += 1.0
    moved = (emulate_row_blocks(k2, vt, wt, torch.from_numpy(s0)) != base).any(-1)
    assert moved.nonzero().tolist() == [[0, 20]]


def _tf32_split(x):
    """The kernel's 3xTF32 split of float32 values: big = x rounded to TF32
    (half an ulp added to the bits, the low 13 cleared), small = x - big,
    of which the tensor core reads the top 19 bits."""
    bits = x.astype(np.float32).view(np.uint32)
    big = ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)
    small = (x.astype(np.float32) - big).view(np.uint32) & np.uint32(0xFFFFE000)
    return big.astype(np.float64), small.view(np.float32).astype(np.float64)


def _mma_m16n8k8(afrag, bfrag, cfrag):
    """One warp's mma.sync m16n8k8 from its lanes' fragments (g = lane / 4,
    t = lane % 4: A a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t +
    4); B b0 (t, g), b1 (t + 4, g); C c0, c1 (g, 2t, 2t + 1), c2, c3 (g + 8,
    the same)), in float64."""
    A, B = np.zeros((16, 8)), np.zeros((8, 8))
    for lane in range(32):
        g, t = divmod(lane, 4)
        A[g, t], A[g + 8, t], A[g, t + 4], A[g + 8, t + 4] = afrag[lane]
        B[t, g], B[t + 4, g] = bfrag[lane]
    D = A @ B
    for lane in range(32):
        g, t = divmod(lane, 4)
        cfrag[lane] += [D[g, 2 * t], D[g, 2 * t + 1], D[g + 8, 2 * t], D[g + 8, 2 * t + 1]]


@pytest.mark.parametrize("nt", (64, 37, 8, 1))
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_the_row_block_fragments_roll_one_tile(nt, dtype):
    """One CTA's tile as ``csrc/wkv6_state.cu``'s row-block kernel computes
    it, lane by lane: each row's suffix products by its half-warp (lane q
    holding step q + 16j of each block j of 16 steps: a Hillis-Steele scan
    of shuffles down within each block, times the later blocks' products),
    k~ and P, then each warp's 16 x 8 block of the state, held as two
    accumulators each scaled by P, plus ceil(nt / 8) k-steps of m16n8k8
    products, the even ones into the first and the odd into the second,
    whose k positions t and t + 4 are steps 2t and 2t + 1 (k~ split 3xTF32
    against v: two passes for bf16 v, three for float32). Every state
    element is one lane's, once, and the result is P S + k~^T v within
    float32 rounding."""
    rng = np.random.RandomState(nt)
    R, TILE, D = wks.ROWS, wks.TILE, 64
    d = np.ones((R, TILE), np.float32)
    d[:, :nt] = np.exp(-np.exp(rng.uniform(-8, 1, (R, nt)))).astype(np.float32)
    kk = np.zeros((R, TILE), np.float32)
    kk[:, :nt] = _bf16(rng.standard_normal((R, nt)).astype(np.float32))
    v = np.zeros((TILE, D), np.float32)  # steps past nt zero-filled
    v[:nt] = rng.standard_normal((nt, D)).astype(np.float32)
    if dtype == "bfloat16":
        v = _bf16(v)
    S = rng.standard_normal((R, D)).astype(np.float32)
    # the scan: thread q of row r takes step q + 16j of each block j of 16 steps
    ka, P = np.zeros((R, TILE), np.float32), np.zeros(R, np.float32)
    lanes = np.arange(16)
    for r in range(R):
        blocks = d[r].reshape(4, 16)  # [j, q]
        inc = blocks.copy()
        off = 1
        while off < 16:
            down = np.concatenate([inc[:, off:], inc[:, -off:]], axis=1)  # past 15: their own
            inc = np.where(lanes + off < 16, inc * down, inc)
            off *= 2
        after = np.float32(1)
        for j in (3, 2, 1, 0):
            m = np.concatenate([inc[j, 1:], [np.float32(1)]])
            ka[r, 16 * j + lanes] = kk[r, 16 * j + lanes] * (m * after)
            after = after * inc[j, 0]
        P[r] = after
    after = np.cumprod(d[:, ::-1].astype(np.float64), axis=1)[:, ::-1]
    m_want = np.concatenate([after[:, 1:], np.ones((R, 1))], axis=1)
    np.testing.assert_allclose(ka, kk * m_want, rtol=2e-6, atol=1e-30)
    np.testing.assert_allclose(P, after[:, 0], rtol=2e-6, atol=1e-30)
    # the product: warp w owns columns 8w .. 8w + 7 of all 16 rows
    got, seen = np.zeros((R, D)), np.zeros((R, D), int)
    for w in range(D // 8):
        chains = np.zeros((2, 32, 4))  # c (the state at entry, then even k-steps), e (odd)
        for lane in range(32):
            g, t = divmod(lane, 4)
            col = 8 * w + 2 * t
            chains[0, lane] = [S[g, col] * P[g], S[g, col + 1] * P[g], S[g + 8, col] * P[g + 8],
                               S[g + 8, col + 1] * P[g + 8]]
        for k8 in range(-(-nt // 8)):
            c = chains[k8 % 2]
            a = np.zeros((32, 4), np.float32)
            b = np.zeros((32, 2), np.float32)
            for lane in range(32):
                g, t = divmod(lane, 4)
                step = 8 * k8 + 2 * t
                a[lane] = [ka[g, step], ka[g + 8, step], ka[g, step + 1], ka[g + 8, step + 1]]
                b[lane] = [v[step, 8 * w + g], v[step + 1, 8 * w + g]]
            ab, as_ = _tf32_split(a)
            if dtype == "bfloat16":  # v exact in TF32
                for part in (as_, ab):
                    _mma_m16n8k8(part, b.astype(np.float64), c)
            else:
                bb, bs = _tf32_split(b)
                for pa, pb in ((as_, bb), (ab, bs), (ab, bb)):
                    _mma_m16n8k8(pa, pb, c)
        for lane in range(32):
            g, t = divmod(lane, 4)
            col = 8 * w + 2 * t
            for (row, cc), x in zip(((g, col), (g, col + 1), (g + 8, col), (g + 8, col + 1)),
                                    chains[0, lane] + chains[1, lane]):
                got[row, cc] = x
                seen[row, cc] += 1
    assert (seen == 1).all()
    want = P[:, None].astype(np.float64) * S + ka.astype(np.float64) @ v.astype(np.float64)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N", (8, 16, 32, 64))
def test_the_variant_rule_and_the_row_grid_at_their_edges(N):
    """The row-block kernel up to the 512-token piece, segmented from 513
    (the whole prompts and phase 11's 32,768); its grid ceil(N / ROWS) row
    blocks by BH, 16 rows (one mma tile) and 8 warps of 8 columns each."""
    assert wks.ROW_BLOCKS_MAX_T == 512
    for T in (1, 2, 63, 64, 65, 256, 511, 512):
        assert wks.variant(T) == "row_blocks"
    for T in (513, 742, 1024, 32768):
        assert wks.variant(T) == "segmented"
    for BH in (1, 32, 128, 1000):
        blocks = -(-N // wks.ROWS)
        assert wks.row_grid(BH, N) == (blocks, BH)
        assert (blocks - 1) * wks.ROWS < N <= blocks * wks.ROWS  # no CTA past N
    assert wks.ROWS == 16 and wks.ROW_THREADS == 8 * 32  # 8 warps x 8 columns: 64
    assert wks.row_grid(32, 64) == (4, 32)  # rwkv6: 128 CTAs, one wave on 132 SMs
    assert set(wks.VARIANT_CODES) == {"row_blocks", "segmented"}


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
        # k, v, w, s0, s_out, B, H, T, N, V, strides, dtype, variant, split, stream
        strides = list((ctypes.c_longlong * 9).from_address(a[10]))
        self.calls.append(("wkv6_state", {"s0": a[3], "s_out": a[4], "B": a[5], "H": a[6],
                                          "T": a[7], "N": a[8], "V": a[9], "strides": strides,
                                          "dtype": a[11], "variant": a[12], "split": a[13]}))
        return 0


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_a_prefill_launches_one_scan_and_in_bf16_one_state_pass_per_layer(dtype, monkeypatch):
    """The smoke variant's prefill on the kernels' route with the launches
    stubbed: per layer one ``wkv6_scan`` and, in bf16 only, one
    ``wkv6_state`` from float32 w into the layer's cache in place (the
    scan's own state a scratch buffer), by ``variant(T)``'s kernel (at
    70 steps the row blocks of ``ROWS`` rows); as ``rwkv.prefill_launches``
    says."""
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
    assert ops.COUNTERS["wkv6_state"].variants == {"row_blocks": L}
    assert ops.COUNTERS["wkv6_state"].sizes == {S: L}  # a layer's launch, T = S
    assert ops.COUNTERS["wkv6_state"].variant_sizes == {("row_blocks", S): L}
    assert ops.COUNTERS["wkv6_scan"].variant_sizes == {("chunked", S): L}
    for layer in range(L):
        scan, state = lib.calls[2 * layer][1], lib.calls[2 * layer + 1][1]
        wkv = caches["wkv"][layer].data_ptr()
        assert scan["w_f32"] == 0 and scan["s_out"] != wkv  # rounded w; its state a scratch
        assert state["s0"] == state["s_out"] == wkv and state["dtype"] == 1
        assert (state["B"], state["H"], state["T"], state["N"], state["V"]) == (B, H, S, N, N)
        assert wks.variant(S) == "row_blocks"
        assert (state["variant"], state["split"]) == (wks.VARIANT_CODES["row_blocks"], wks.ROWS)
        # the (B, H, S, N) views of (B, S, H, N) projections, passed as they are
        assert state["strides"] == [S * H * N, N, H * N] * 3


def test_the_wrapper_counts_its_launches_by_length(monkeypatch):
    """Each launch counts once in all, once under its variant, once under
    its length T and once under both (the piece sizes' launches by variant
    that chip_smoke.py's K5-state rows report); a call that raises counts
    nothing. ``kernel=`` forces a variant; the C side gets its code and
    split (segments a head, or rows a CTA)."""
    lib = _StubLib()
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: None)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    ops.reset_counters()
    gen = torch.Generator().manual_seed(3)
    for T in (512, 64, 1, 64, 1, 1, 1024):
        k, v = (torch.randn(2, T, 32, generator=gen).to(torch.bfloat16) for _ in range(2))
        wks.wkv6_state(k, v, torch.randn(2, T, 32, generator=gen))
    wks.wkv6_state(k, v, torch.randn(2, 1024, 32, generator=gen), kernel="row_blocks")
    with pytest.raises(TypeError):
        wks.wkv6_state(k, v, torch.randn(2, 1024, 32, generator=gen).to(torch.bfloat16))
    with pytest.raises(ValueError, match="no kernel"):
        wks.wkv6_state(k, v, torch.randn(2, 1024, 32, generator=gen), kernel="rows")
    c = ops.COUNTERS["wkv6_state"]
    assert (c.launches, c.variants, c.sizes) == (8, {"row_blocks": 7, "segmented": 1},
                                                 {512: 1, 64: 2, 1: 3, 1024: 2})
    assert c.variant_sizes == {("row_blocks", 512): 1, ("row_blocks", 64): 2,
                               ("row_blocks", 1): 3, ("segmented", 1024): 1,
                               ("row_blocks", 1024): 1}
    assert [a["T"] for _, a in lib.calls] == [512, 64, 1, 64, 1, 1, 1024, 1024]
    codes = wks.VARIANT_CODES
    assert [(a["variant"], a["split"]) for _, a in lib.calls] == \
        [(codes["row_blocks"], wks.ROWS)] * 6 + [(codes["segmented"], wks.segments(2, 1024)),
                                                 (codes["row_blocks"], wks.ROWS)]


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
