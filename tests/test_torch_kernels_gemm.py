"""The port's GEMM ops (K1 ``batched_gemm``, K2 ``grouped_gemm``) against
the JAX package's Pallas kernels in interpret mode and its jnp oracles.

On the CPU the port's ops run their plain PyTorch versions (``ref``); the
CUDA kernels are held against those on the card by ``chip_smoke.py``
phase 4. Inputs are made with numpy from a seed and fed to both packages.
Tolerances are the JAX kernel tests' own (``tests/test_kernels_batched_gemm.py``,
``tests/test_kernels_grouped_gemm.py``).
"""

import numpy as np
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.batched_gemm import batched_gemm as jax_batched_gemm  # noqa: E402
from repro.kernels.grouped_gemm import grouped_gemm as jax_grouped_gemm  # noqa: E402
from repro.kernels.grouped_gemm import make_group_layout as jax_make_group_layout  # noqa: E402

from repro_torch.kernels import batched_gemm as tbg  # noqa: E402
from repro_torch.kernels import grouped_gemm as tgg  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402

SHAPES = [
    # (R, M, K, N), as tests/test_kernels_batched_gemm.py
    (2, 512, 512, 1),        # RNN matvec
    (4, 256, 1152, 128),     # ResNet-18 conv2_2 im2col
    (3, 256, 256, 256),      # square
    (1, 128, 128, 128),      # single problem degenerates to plain GEMM
    (5, 100, 70, 33),        # ragged in every dim
    (8, 16, 512, 16),        # tiny M/N, deep K
]
DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
GROUP_SIZES = [[64, 64], [100, 5, 0, 260], [1, 1, 1], [300]]


def _both(a: np.ndarray, dtype: str):
    """The same values in both packages (bf16 rounds identically in each)."""
    jdt, tdt = DTYPES[dtype]
    return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)


def _np(t) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.float().numpy()
    return np.asarray(t, np.float32)


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_batched_gemm_matches_pallas_and_oracle(shape, dtype):
    R, M, K, N = shape
    rng = np.random.default_rng(SHAPES.index(shape))
    xj, xt = _both(rng.standard_normal((R, M, K), np.float32), dtype)
    wj, wt = _both(rng.standard_normal((R, K, N), np.float32), dtype)
    assert np.array_equal(_np(xj), _np(xt)) and np.array_equal(_np(wj), _np(wt))
    got = ops.batched_gemm(xt, wt)
    assert got.dtype == xt.dtype and tuple(got.shape) == (R, M, N)
    tol = 2e-2 if dtype == "bfloat16" else 2e-4
    for want in (jax_batched_gemm(xj, wj, interpret=True), jref.batched_gemm(xj, wj)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * K ** 0.5)


def test_batched_gemm_problem_independence():
    """Problem r's output depends only on x[r] and w[r], bit for bit -- the
    isolation property of the merged super-kernel."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.standard_normal((4, 64, 64), np.float32))
    w = torch.from_numpy(rng.standard_normal((4, 64, 64), np.float32))
    base = ops.batched_gemm(x, w)
    x2 = x.clone()
    x2[2] = torch.from_numpy(rng.standard_normal((64, 64), np.float32))
    pert = ops.batched_gemm(x2, w)
    for r in (0, 1, 3):
        assert torch.equal(base[r], pert[r])
    assert not torch.allclose(base[2], pert[2])


def _group_inputs(sizes, bm, K, N, dtype, seed):
    offs, bgroups, T = jax_make_group_layout(np.array(sizes), bm=bm)
    rng = np.random.default_rng(seed)
    x = np.zeros((T, K), np.float32)
    for g, sz in enumerate(sizes):
        x[offs[g]:offs[g] + sz] = rng.standard_normal((sz, K))
    w = rng.standard_normal((len(sizes), K, N)).astype(np.float32)
    return _both(x, dtype), _both(w, dtype), bgroups


@pytest.mark.parametrize("sizes", GROUP_SIZES, ids=str)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("bm", [32, 96])  # 96: a row block of 1.5 CUDA tiles
def test_grouped_gemm_matches_pallas(sizes, dtype, bm):
    (xj, xt), (wj, wt), bgroups = _group_inputs(sizes, bm, 48, 40, dtype,
                                                GROUP_SIZES.index(sizes))
    got = ops.grouped_gemm(xt, wt, bgroups, bm=bm)
    assert got.dtype == xt.dtype and tuple(got.shape) == (xt.shape[0], 40)
    tol = 3e-2 if dtype == "bfloat16" else 2e-4
    for want in (jax_grouped_gemm(xj, wj, jnp.asarray(bgroups), bm=bm, bn=32, bk=32,
                                  interpret=True),
                 jref.grouped_gemm(xj, wj, jnp.asarray(bgroups), bm)):
        np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol * 10)


def test_grouped_gemm_group_isolation():
    """Rows of group g only see w[g]; padded rows of a group come out 0."""
    bm = 16
    (_, xt), (_, wt), bgroups = _group_inputs([16, 9], bm, 24, 8, "float32", 3)
    out = ops.grouped_gemm(xt, wt, bgroups, bm=bm)
    torch.testing.assert_close(out[:16], xt[:16] @ wt[0], rtol=2e-5, atol=1e-4)
    torch.testing.assert_close(out[16:25], xt[16:25] @ wt[1], rtol=2e-5, atol=1e-4)
    assert torch.equal(out[25:], torch.zeros_like(out[25:]))


@pytest.mark.parametrize("seed", range(50))
def test_make_group_layout_matches_jax(seed):
    rng = np.random.default_rng(seed)
    sizes = rng.integers(0, 300, size=int(rng.integers(1, 9)))
    sizes[rng.random(len(sizes)) < 0.2] = 0  # empty groups too
    bm = int(rng.choice([16, 32, 64, 128]))
    for got, want in zip(tgg.make_group_layout(sizes, bm=bm),
                         jax_make_group_layout(sizes, bm=bm)):
        got, want = np.asarray(got), np.asarray(want)
        assert got.dtype == want.dtype and np.array_equal(got, want)


def test_block_group_ids_are_checked_on_the_host():
    ids = tgg.host_block_groups(np.array([0, 2, 1], np.int64), 3, 3)
    assert ids.dtype == np.int32 and list(ids) == [0, 2, 1]
    with pytest.raises(TypeError, match="host"):
        tgg.host_block_groups(torch.tensor([0, 2, 1]), 3, 3)
    with pytest.raises(ValueError, match="lie in"):
        tgg.host_block_groups(np.array([0, 3]), 2, 3)
    with pytest.raises(ValueError, match="lie in"):
        tgg.host_block_groups(np.array([-1, 0]), 2, 3)
    with pytest.raises(ValueError, match="shape"):
        tgg.host_block_groups(np.array([0, 1, 1]), 2, 3)
    with pytest.raises(TypeError):
        tgg.host_block_groups(np.array([0.0, 1.0]), 2, 3)


def test_cpu_tensors_take_the_plain_version(monkeypatch):
    """On CPU tensors the ops call the plain version (counted) and never
    the kernel wrappers, which would raise."""
    def no_kernel(*args, **kwargs):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    monkeypatch.setattr(tbg, "batched_gemm", no_kernel)
    monkeypatch.setattr(tgg, "grouped_gemm", no_kernel)
    ops.reset_counters()
    ops.batched_gemm(torch.ones(2, 3, 4), torch.ones(2, 4, 5))
    ops.grouped_gemm(torch.ones(32, 4), torch.ones(2, 4, 5), np.array([0, 1]), bm=16)
    counts = {k: (c.launches, c.plain_calls) for k, c in ops.COUNTERS.items()}
    assert counts["batched_gemm"] == (0, 1) and counts["grouped_gemm"] == (0, 1)


def test_wrappers_refuse_cpu_tensors_and_other_devices():
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbg.batched_gemm(torch.ones(1, 2, 2), torch.ones(1, 2, 2))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tgg.grouped_gemm(torch.ones(16, 2), torch.ones(1, 2, 2), np.array([0]), bm=16)
    class Elsewhere:  # a tensor on a device with neither a kernel nor a plain version
        is_cuda = False
        device = torch.device("xpu")

    with pytest.raises(ValueError, match="no kernel for device"):
        ops.batched_gemm(Elsewhere(), Elsewhere())
    # the meta device (the dry run's) goes to the plain version by device, as the CPU does
    out = ops.batched_gemm(torch.ones(1, 2, 2, device="meta"), torch.ones(1, 2, 2, device="meta"))
    assert out.device.type == "meta" and tuple(out.shape) == (1, 2, 2)
