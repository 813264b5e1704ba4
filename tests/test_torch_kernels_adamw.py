"""The AdamW kernels' host side and plain versions on the CPU.

``kernels/adamw.py`` launches two CUDA kernels a step on the card (the
global norm, then every leaf's update in one pass); here, with no card:
its plan covers every element of every leaf once, grouped by dtype and
inside the launch's parameter limit (the two real trees' leaf sizes from
the meta device, and edge trees); the packs it hands the kernel, read back
through a stand-in library and applied the way the kernel maps blocks to
leaves, give the plain version's params and moments bit for bit; the plain
versions match the JAX package's ``adamw_update`` over 5 steps; the CPU and
meta routes count plain calls and no launch; the wrappers refuse what the
kernel does not take; ``make_train_step`` makes a strided gradient
contiguous; and phase 10's AdamW check, rehearsed, fails when the kernel is
wrong or the optimizer takes the plain path.

Tolerance against the reference: 1e-6 of each leaf's largest magnitude, as
``test_torch_training.py`` holds ``adamw_update`` (both compute in float32;
the global norm is a float32 sum whose order XLA and PyTorch choose
differently).
"""

import contextlib
import dataclasses
import pkgutil
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core

import repro_torch  # noqa: E402
from repro_torch.config import get_config, smoke_variant  # noqa: E402
from repro_torch.kernels import _build, adamw, ops, ref  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.optimizer import adamw_init, adamw_update  # noqa: E402
from repro_torch.training.optimizer import lr_schedule  # noqa: E402
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
OPT_RTOL = 1e-6
BF16, F32 = torch.bfloat16, torch.float32
HYPER = dict(b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1)


def meta_tree(arch):
    """(numels, dtypes) of ``arch``'s full-width param tree, from the meta
    device (no memory)."""
    model = build_model(get_config(arch), device="meta")
    leaves = tree_leaves(model._alloc(model._param_specs(), ()))
    return [p.numel() for p in leaves], [p.dtype for p in leaves]


EDGE_TREES = {
    "one leaf": ([5000], [BF16]),
    "a leaf of 1 element": ([1, 7, 8, 9], [F32, BF16, F32, BF16]),
    "more leaves than a pack": ([3 + i % 5 for i in range(adamw.MAX_LEAVES + 37)],
                                [F32 if i % 3 else BF16 for i in range(adamw.MAX_LEAVES + 37)]),
    "leaves across tiles, empty ones": ([adamw.TILE * 3 + 5, 0, adamw.TILE, 1, 0],
                                        [BF16, F32, F32, BF16, BF16]),
}


def find_leaf(tile0, t):
    """The kernel's search: the last leaf whose first tile is <= t."""
    lo, hi = 0, len(tile0) - 1
    while lo < hi:
        mid = (lo + hi + 1) >> 1
        if tile0[mid] <= t:
            lo = mid
        else:
            hi = mid - 1
    return lo


def blocks(plan, numels):
    """What each launch's blocks touch, as the kernel maps them: (pack,
    leaf index, first element, end element) for every block."""
    for pk in plan.packs:
        for b in range(pk.tiles):
            t = pk.tile0[0] + b
            j = find_leaf(pk.tile0, t)
            leaf = pk.leaves[j]
            e0 = (t - pk.tile0[j]) * adamw.TILE
            yield pk, j, leaf, e0, min(e0 + adamw.TILE, numels[leaf])


# ------------------------------------------------------------------ the plan
@pytest.mark.parametrize("tree", ["stablelm-1.6b", "rwkv6-1.6b", *EDGE_TREES])
def test_plan_covers_every_element_once_grouped_by_dtype(tree):
    numels, dtypes = meta_tree(tree) if tree in ("stablelm-1.6b", "rwkv6-1.6b") \
        else EDGE_TREES[tree]
    plan = adamw.plan(numels, dtypes)
    assert adamw.PARAM_BYTES <= adamw.PARAM_LIMIT_BYTES
    order = [i for pk in plan.packs for i in pk.leaves]
    # every non-empty leaf in exactly one pack, bf16 ones first, each group in tree order
    assert order == [i for dt in (BF16, F32) for i, d in enumerate(dtypes)
                     if d == dt and numels[i] > 0]
    tile = 0
    for pk in plan.packs:
        assert 1 <= len(pk.leaves) <= adamw.MAX_LEAVES
        assert all(dtypes[i] == BF16 for i in pk.leaves[:pk.first_f32])
        assert all(dtypes[i] == F32 for i in pk.leaves[pk.first_f32:])
        for i, t0 in zip(pk.leaves, pk.tile0):  # the chain the C entry checks
            assert t0 == tile
            tile += adamw.tiles_of(numels[i])
        assert pk.tiles == tile - pk.tile0[0]
    assert plan.tiles == tile
    # the blocks' element ranges tile each leaf exactly once
    covered = {}
    for pk, j, leaf, e0, e1 in blocks(plan, numels):
        assert e0 < e1
        covered.setdefault(leaf, []).append((e0, e1))
    for leaf, ranges in covered.items():
        ranges.sort()
        assert ranges[0][0] == 0 and ranges[-1][1] == numels[leaf]
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))
    assert sorted(covered) == sorted(order)
    if tree in ("stablelm-1.6b", "rwkv6-1.6b"):  # one launch of each kernel a step
        assert len(plan.packs) == 1 and len(order) == len(numels)


def test_plan_refuses_other_dtypes_and_bounds_the_norm():
    with pytest.raises(TypeError, match="float16"):
        adamw.plan([4], [torch.float16])
    with pytest.raises(ValueError):
        adamw.plan([4, 5], [F32])
    assert adamw.plan([0, 0], [F32, BF16]).packs == ()
    # stablelm-1.6b's 200,753 tiles: a chain of 833 additions, ~2.5e-5
    assert 2e-5 < adamw.norm_rtol(200753) < 3e-5
    assert adamw.norm_rtol(1) < 2e-6


# ----------------------------------------------- the packs, read back on the CPU
def bf16_round(x):
    """float32 -> bf16 -> float32, round to nearest even (finite x)."""
    u = x.astype(np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def elementwise_update(g, p, m, v, s, c):
    """The kernel's per-element arithmetic in numpy float32 (each operation
    rounded once, the square root correctly rounded, as on the card); ``s``
    (scale, bc1, bc2, lr) and ``c`` (b1, 1 - b1, b2, 1 - b2, eps, wd) are
    float32. Returns the new (p as float32, m, v)."""
    g32 = g * s[0]
    m = m * c[0] + c[1] * g32
    v = v * c[2] + c[3] * (g32 * g32)
    delta = (m / s[1]) / (np.sqrt(v / s[2]) + c[4]) + c[5] * p
    return p - s[3] * delta, m, v


def apply_update(g, p, m, v, lo, hi, s, c):
    """``elementwise_update`` on elements [lo, hi) of flat tensors, in place."""
    pn, mn, vn = elementwise_update(g[lo:hi].float().numpy(), p[lo:hi].float().numpy(),
                                    m[lo:hi].numpy(), v[lo:hi].numpy(), s, c)
    m[lo:hi] = torch.from_numpy(mn)
    v[lo:hi] = torch.from_numpy(vn)
    p[lo:hi] = torch.from_numpy(bf16_round(pn) if p.dtype == BF16 else pn).to(p.dtype)


class PackReader:
    """A stand-in for the kernel library: reads every launch's pack as the
    C entry gets it and applies it to the CPU tensors its pointers name,
    block by block as the kernel maps blocks to leaves and elements."""

    def __init__(self, tensors):
        self.by_ptr = {t.data_ptr(): t for t in tensors}
        self.calls = []

    def repro_adamw(self, kind, n, first_f32, tile0, tiles, total, ptrs, numels, tile0s,
                    partials, done, gnorm, scale, bc1, bc2, lr, b1, c1, b2, c2, eps, wd,
                    stream):
        import ctypes

        flat = (ctypes.c_longlong * (4 * n)).from_address(ptrs)
        sizes = list((ctypes.c_longlong * n).from_address(numels))
        starts = list((ctypes.c_longlong * n).from_address(tile0s))
        self.calls.append((kind, n, first_f32, tile0, tiles, total, sizes, starts))
        assert starts[0] == tile0 and total >= tile0 + tiles
        if kind == 0:
            return 0
        c = [np.float32(x) for x in (b1, c1, b2, c2, eps, wd)]
        s = [np.float32(self.by_ptr[a].item()) for a in (scale, bc1, bc2, lr)]
        for b in range(tiles):
            t = tile0 + b
            j = find_leaf(starts, t)
            e0 = (t - starts[j]) * adamw.TILE
            g, p, m, v = (self.by_ptr[flat[4 * j + k]].view(-1) for k in range(4))
            assert (p.dtype == BF16) == (j < first_f32) and g.dtype == p.dtype
            apply_update(g, p, m, v, e0, min(e0 + adamw.TILE, sizes[j]), s, c)
        return 0

    def repro_adamw_error(self, code):
        return b"stand-in"


def seeded_tree(numels, dtypes, seed=0, zero_grad=None):
    rng = np.random.RandomState(seed)
    params, grads, mus, nus = [], [], [], []
    for i, (n, dt) in enumerate(zip(numels, dtypes)):
        params.append(torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(dt))
        g = rng.standard_normal(n).astype(np.float32) * (0.0 if i == zero_grad else 2.0)
        grads.append(torch.from_numpy(g).to(dt))
        mus.append(torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 0.1))
        nus.append(torch.from_numpy(np.square(rng.standard_normal(n).astype(np.float32)) * 0.1))
    return params, grads, mus, nus


@contextlib.contextmanager
def card_stand_in(monkeypatch, lib):
    """The wrappers' card-only calls made to pass on CPU tensors, the library
    replaced by ``lib``; the counters restored after."""
    saved = {k: c.copy() for k, c in ops.COUNTERS.items()}
    monkeypatch.setattr(_build, "check_device", lambda t: None)
    monkeypatch.setattr(_build, "load", lambda name: lib)
    monkeypatch.setattr(_build, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch.cuda, "device", lambda d: contextlib.nullcontext())
    ops.reset_counters()
    try:
        yield
    finally:
        for k, c in ops.COUNTERS.items():
            c.reset()
            c.add(saved[k])


@pytest.mark.parametrize("tree", ["a leaf of 1 element", "more leaves than a pack",
                                  "leaves across tiles, empty ones"])
def test_the_packs_give_the_kernels_update_of_every_leaf(tree, monkeypatch):
    """The packs, applied block by block, give every leaf's update bit for
    bit as the same arithmetic applied leaf by leaf, and the plain version's
    within float32 rounding (on the CPU its square root is the vector
    library's, not correctly rounded as on the card)."""
    numels, dtypes = EDGE_TREES[tree]
    want = seeded_tree(numels, dtypes, seed=3)
    plain = [[t.clone() for t in ts] for ts in want]
    kern = [[t.clone() for t in ts] for ts in want]
    scalars = [torch.tensor(x, dtype=F32) for x in (0.37, 0.19, 0.0975, 3e-3)]
    lib = PackReader([t for ts in kern for t in ts] + scalars)
    with card_stand_in(monkeypatch, lib):
        adamw.update(*kern, *scalars, **HYPER)
        launches = adamw.counter.copy()
    s = [np.float32(t.item()) for t in scalars]
    c = [np.float32(x) for x in (0.9, 1 - 0.9, 0.95, 1 - 0.95, 1e-8, 0.1)]
    for p, g, m, v in zip(*want):
        apply_update(g.view(-1), p.view(-1), m.view(-1), v.view(-1), 0, p.numel(), s, c)
    ref.adamw_update(*plain, *scalars, **HYPER)
    plan = adamw.plan(numels, dtypes)
    assert launches.variants == {adamw.VARIANT: len(plan.packs)}
    assert [c[:6] for c in lib.calls] == [
        (1, len(pk.leaves), pk.first_f32, pk.tile0[0], pk.tiles, plan.tiles)
        for pk in plan.packs]
    for got, exact, near in zip(kern, want, plain):
        for g, w, n in zip(got, exact, near):
            assert torch.equal(g, w)
            torch.testing.assert_close(g, n, rtol=1e-6, atol=0, check_dtype=True) \
                if g.dtype == F32 else torch.testing.assert_close(g, n, rtol=2 ** -7, atol=0)
    # a control: the bias corrections swapped no longer match
    swapped = [[t.clone() for t in ts] for ts in seeded_tree(numels, dtypes, seed=3)]
    lib2 = PackReader([t for ts in swapped for t in ts] + scalars)
    with card_stand_in(monkeypatch, lib2):
        adamw.update(*swapped, scalars[0], scalars[2], scalars[1], scalars[3], **HYPER)
    assert not all(torch.equal(a, b) for a, b in zip(swapped[0], want[0]))


def test_the_norm_pass_hands_over_every_gradient(monkeypatch):
    numels, dtypes = EDGE_TREES["more leaves than a pack"]
    _, grads, _, _ = seeded_tree(numels, dtypes, seed=1)
    lib = PackReader(grads)
    with card_stand_in(monkeypatch, lib):
        out = adamw.norm(grads)
        launches = ops.COUNTERS["adamw_norm"].copy()
    plan = adamw.plan(numels, dtypes)
    assert out.shape == () and out.dtype == F32
    assert launches.variants == {adamw.VARIANT: len(plan.packs)} == {adamw.VARIANT: 2}
    assert [c[6] for c in lib.calls] == [[numels[i] for i in pk.leaves] for pk in plan.packs]


# ----------------------------------------- the plain versions against the reference
def _reference_trees():
    mixed = {"a": ((3, 5), "bfloat16"), "b": [((7,), "float32"), ((2, 2, 2), "bfloat16")],
             "c": ((4,), "float32")}
    zero = {"w": ((6, 3), "float32"), "z": ((5,), "float32"), "e": ((2, 4), "bfloat16")}
    big = {"big": ((adamw.TILE * 2 + 13,), "bfloat16"), "f": ((9,), "float32"),
           "small": [((16,), "float32") for _ in range(adamw.MAX_LEAVES + 5)]}
    return {"mixed bf16 and float32": (mixed, None), "a zero-gradient leaf": (zero, "z"),
            "larger than one tile and one pack": (big, None)}


@pytest.mark.parametrize("name", list(_reference_trees()))
def test_plain_update_matches_reference_over_five_steps(name):
    jax = pytest.importorskip("jax")
    jnp = jax.numpy
    from repro.training.optimizer import adamw_init as jadamw_init
    from repro.training.optimizer import adamw_update as jadamw_update
    from repro.training.optimizer import lr_schedule as jlr_schedule

    spec, zero_key = _reference_trees()[name]
    is_leaf = lambda x: isinstance(x, tuple)  # noqa: E731
    rng = np.random.RandomState(7)
    init = jax.tree.map(lambda s: rng.standard_normal(s[0]).astype(np.float32), spec,
                        is_leaf=is_leaf)
    dts = jax.tree.map(lambda s: s[1], spec, is_leaf=is_leaf)
    jp = jax.tree.map(lambda a, d: jnp.asarray(a, d), init, dts)
    tp = jax.tree.map(lambda a, d: torch.from_numpy(a).to(getattr(torch, d)), init, dts)
    jopt, topt = jadamw_init(jp), adamw_init(tp)
    jstep = jadamw_update
    for step in range(5):
        scale = 0.5 if step % 2 else 3.0
        grads = {k: jax.tree.map(
            lambda s: (rng.standard_normal(s[0]) * (0.0 if k == zero_key else scale)).astype(
                np.float32), v, is_leaf=is_leaf) for k, v in spec.items()}
        tgrads = jax.tree.map(lambda a, d: torch.from_numpy(a).to(getattr(torch, d)), grads, dts)
        jgrads = jax.tree.map(lambda a, d: jnp.asarray(a, d), grads, dts)
        jp, jopt, jm = jstep(jgrads, jopt, jp, jlr_schedule(jopt.step, 1e-2, 2, 5))
        tp, topt, tm = adamw_update(tgrads, topt, tp, lr_schedule(topt.step, 1e-2, 2, 5))
        assert int(topt.step) == int(jopt.step) == step + 1
        for key in ("grad_norm", "lr"):
            assert float(tm[key]) == pytest.approx(float(jm[key]), rel=OPT_RTOL)
    for got, want in ((tp, jp), (topt.mu, jopt.mu), (topt.nu, jopt.nu)):
        got = jax.tree.map(lambda t: t.float().numpy(), got)  # the reference's leaf order
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            w = np.asarray(w, np.float32)
            np.testing.assert_allclose(g, w, rtol=0, atol=OPT_RTOL * float(np.abs(w).max()))
    if zero_key is not None:  # no gradient: only weight decay moved it, moments stay 0
        assert not tm["grad_norm"].isnan() and float(topt.mu[zero_key].abs().max()) == 0.0


# ------------------------------------------------------------------ the routes
@pytest.fixture
def counters():
    saved = {k: c.copy() for k, c in ops.COUNTERS.items()}
    ops.reset_counters()
    yield ops.COUNTERS
    for k, c in ops.COUNTERS.items():
        c.reset()
        c.add(saved[k])


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_off_the_card_the_update_is_plain_and_counted(device, counters):
    params = {"a": torch.ones(5, 3, dtype=BF16, device=device),
              "b": [torch.ones(4, device=device)]}
    opt = adamw_init(params)
    grads = {"a": torch.full((5, 3), 0.5, dtype=BF16, device=device),
             "b": [torch.full((4,), -2.0, device=device)]}
    adamw_update(grads, opt, params, torch.tensor(1e-3, device=device))
    assert (counters["adamw_norm"].plain_calls, counters["adamw_update"].plain_calls) == (1, 1)
    assert counters["adamw_norm"].launches == counters["adamw_update"].launches == 0
    assert all(c.launches == 0 for c in counters.values())


def cuda_like(monkeypatch):
    """The device check passed for CPU tensors; loading the library fails,
    so a test sees whether the wrapper got as far as the launch."""
    monkeypatch.setattr(_build, "check_device", lambda t: None)

    def no_launch(name):
        raise AssertionError("reached the launch")
    monkeypatch.setattr(_build, "load", no_launch)


def test_the_wrappers_refuse_cpu_tensors():
    g = [torch.ones(8)]
    with pytest.raises(ValueError, match="CUDA tensor"):
        adamw.norm(g)
    with pytest.raises(ValueError, match="CUDA tensor"):
        adamw.update([torch.ones(8)], g, [torch.zeros(8)], [torch.zeros(8)],
                     *(torch.tensor(1.0) for _ in range(4)), **HYPER)


@pytest.mark.parametrize("fault", ["strided gradient", "strided param", "misaligned moment",
                                   "float16 param", "bf16 moment", "gradient dtype",
                                   "scalar dtype", "sizes differ"])
def test_the_update_wrapper_refuses_what_the_kernel_does_not_take(fault, monkeypatch):
    cuda_like(monkeypatch)
    n = 16
    p, g = torch.ones(n, dtype=BF16), torch.ones(n, dtype=BF16)
    m, v = torch.zeros(n), torch.zeros(n)
    scal = [torch.tensor(x) for x in (1.0, 0.1, 0.05, 1e-3)]
    if fault == "strided gradient":
        g = torch.ones(n, 2, dtype=BF16)[:, 0]
    elif fault == "strided param":
        p = torch.ones(n, 2, dtype=BF16)[:, 1]
    elif fault == "misaligned moment":
        m = torch.zeros(n + 1)[1:]
    elif fault == "float16 param":
        p, g = p.half(), g.half()
    elif fault == "bf16 moment":
        v = v.to(BF16)
    elif fault == "gradient dtype":
        g = g.float()
    elif fault == "scalar dtype":
        scal[1] = scal[1].double()
    else:
        m = torch.zeros(n - 1)
    with pytest.raises((ValueError, TypeError)):
        adamw.update([p], [g], [m], [v], *scal, **HYPER)
    with pytest.raises(AssertionError, match="reached the launch"):  # the sound call does
        adamw.update([torch.ones(n, dtype=BF16)], [torch.ones(n, dtype=BF16)],
                     [torch.zeros(n)], [torch.zeros(n)],
                     *(torch.tensor(x) for x in (1.0, 0.1, 0.05, 1e-3)), **HYPER)


def test_the_norm_wrapper_refuses_a_strided_gradient(monkeypatch):
    cuda_like(monkeypatch)
    with pytest.raises(ValueError, match="contiguous"):
        adamw.norm([torch.ones(8), torch.ones(8, 2)[:, 1]])
    with pytest.raises(AssertionError, match="reached the launch"):
        adamw.norm([torch.ones(8), torch.ones(8, 2)[:, 1].contiguous()])


def test_the_train_step_makes_a_strided_gradient_contiguous():
    """zamba2's depthwise conv weights come back from autograd strided: the
    step copies them contiguous (the kernel refuses strided tensors) and
    names them; the update is the one of the same values contiguous."""
    from repro_torch.training import make_train_step

    cfg = dataclasses.replace(smoke_variant(get_config("zamba2-7b")), dtype="float32")
    model = build_model(cfg, device="cpu")
    gen = torch.Generator()
    gen.manual_seed(0)
    params = model.init(gen)
    step = make_train_step(model)
    assert step.made_contiguous == []
    tok = torch.randint(0, cfg.vocab_size, (1, 8), generator=gen)
    params, opt, metrics = step(params, adamw_init(params), tok, tok)
    names = [path for path, _ in _paths(params)]
    assert step.made_contiguous and all("conv" in names[i] for i in step.made_contiguous)
    assert bool(torch.isfinite(metrics["grad_norm"]))


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k, v in tree.items() for x in _paths(v, f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree) for x in _paths(v, f"{prefix}/{i}")]
    return [(prefix, tree)]


def test_the_scans_cover_the_adamw_wrapper():
    """The package walk and the file scan of ``test_torch_boundary.py``
    reach the wrapper, so it may import neither jax nor anything of repro."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    assert "repro_torch.kernels.adamw" in names
    assert ROOT / "src" / "repro_torch" / "kernels" / "adamw.py" in set(
        (ROOT / "src" / "repro_torch").rglob("*.py"))
    assert "adamw" in _build.SOURCES and "adamw" in _build.SIGNATURES
    src = (ROOT / "src" / "repro_torch" / "kernels" / "adamw.py").read_text()
    assert "import jax" not in src and "from repro." not in src


# --------------------------------------------- phase 10's AdamW check, rehearsed
try:  # phase 10's stand-ins for the card (torch.cuda stubbed, wrappers counting plain)
    from test_torch_train_rehearsal import smoke  # noqa: F401
except pytest.skip.Exception:  # no jax: the rehearsal module skips, and so do these
    smoke = None


@pytest.mark.skipif(smoke is None, reason="phase 10's rehearsal needs jax")
def test_phase_10_fails_when_the_update_kernel_is_wrong(smoke, monkeypatch):  # noqa: F811
    chip_smoke, ops_ = smoke
    right = adamw.update

    def wrong(params, *args, **hyper):
        right(params, *args, **hyper)
        params[0].view(-1)[0] += 1  # one element off
    monkeypatch.setattr(adamw, "update", wrong)
    with pytest.raises(chip_smoke.PhaseFailed, match="differ from the plain update"):
        chip_smoke.phase_adamw(ops_, torch.device("cpu"), 0)


@pytest.mark.skipif(smoke is None, reason="phase 10's rehearsal needs jax")
def test_phase_10_fails_when_the_norm_kernel_is_off(smoke, monkeypatch):  # noqa: F811
    chip_smoke, ops_ = smoke
    right = adamw.norm
    monkeypatch.setattr(adamw, "norm", lambda grads: right(grads) * (1 + 1e-4))
    with pytest.raises(chip_smoke.PhaseFailed, match="over the bound"):
        chip_smoke.phase_adamw(ops_, torch.device("cpu"), 0)


@pytest.mark.skipif(smoke is None, reason="phase 10's rehearsal needs jax")
def test_phase_10_fails_when_the_optimizer_takes_the_plain_path(smoke, monkeypatch):  # noqa: F811
    chip_smoke, ops_ = smoke
    monkeypatch.setattr(ops_, "adamw_update", ops_.adamw_update_plain)
    with pytest.raises(chip_smoke.PhaseFailed, match="AdamW launches"):
        chip_smoke.phase_adamw(ops_, torch.device("cpu"), 0)
