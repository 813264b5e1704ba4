"""The port's sharding rules, activation-constraint rule and analytic
roofline against the JAX package's, on device-less meshes.

Specs: for every architecture at full width, the port's specs of its
abstract params and optimizer state (scan layout, meta tensors) equal the
reference's of ``jax.eval_shape``'s (no allocation on either side) as
tuples, on the pod1, pod2 and host meshes under all four policies; so do
its cache specs (the port's per-layer layout against the reference's unit
stacks, whose leading ``reps`` entry must be None) for ``decode_32k`` and
``long_500k``, and the input specs. ``constraint_spec`` is held against
the spec the reference's ``constrain`` hands to ``with_sharding_constraint``
(captured by patching it and ``NamedSharding`` inside the test).
The analytic costs are pure arithmetic on the configs and must be equal
floats.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
jax = pytest.importorskip("jax")
pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402
from jax.sharding import PartitionSpec as P  # noqa: E402

import repro.distributed.constraints as jcons  # noqa: E402
import repro.distributed.sharding as jshd  # noqa: E402
import repro.launch.roofline as jrl  # noqa: E402
from repro.config import get_config as jget_config  # noqa: E402
from repro.config import get_shape as jget_shape  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.models import build_model as jbuild_model  # noqa: E402

import repro_torch.distributed.constraints as tcons  # noqa: E402
import repro_torch.distributed.sharding as tshd  # noqa: E402
import repro_torch.launch.roofline as trl  # noqa: E402
from repro_torch.config import get_config, get_shape, list_configs  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.convert import _layer_sources  # noqa: E402
from repro_torch.models.transformer import cache_slots  # noqa: E402

settings.register_profile("torch_sharding", max_examples=60, deadline=None)

ARCHS = list_configs()
MESHES = {"pod1": make_production_mesh(), "pod2": make_production_mesh(multi_pod=True),
          "host": make_host_mesh()}
POLICIES = ("fsdp", "tp", "replicate", "auto")


class StubMesh:
    """The reference's rules read only axis_names and shape[axis] (its own
    tests stub a mesh so)."""

    def __init__(self, mesh: Mesh):
        self.axis_names = mesh.axis_names
        self.shape = dict(mesh.shape)


def _tuples(tree):
    return jax.tree.map(tuple, tree, is_leaf=lambda x: isinstance(x, P))


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    jm = jbuild_model(jget_config(arch))
    tm = build_model(get_config(arch), device="meta")
    return jsteps.abstract_params(jm), tsteps.abstract_params(tm), jm, tm


def _shapes(tree):
    return jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype).replace("torch.", "")), tree)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_params_equal_the_reference_in_scan_layout(arch):
    """The port's meta params in the scan layout have the reference's tree,
    shapes and dtypes leaf for leaf."""
    jp, tp, _, _ = _abstract(arch)
    assert _shapes(tp) == _shapes(jp)


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_equal_the_reference(arch, mesh_name):
    jp, tp, _, _ = _abstract(arch)
    mesh = MESHES[mesh_name]
    stub = StubMesh(mesh)
    for policy in POLICIES:
        assert tshd.param_specs(tp, mesh, policy) == _tuples(jshd.param_specs(jp, stub, policy)), \
            policy
        assert tshd.opt_state_specs(tp, mesh, policy) == \
            _tuples(jshd.opt_state_specs(jp, stub, policy)), policy


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_cache_and_input_specs_equal_the_reference(arch, shape_name):
    _, _, jm, tm = _abstract(arch)
    cfg = get_config(arch)
    shape = get_shape(shape_name)
    B, S = shape.global_batch, shape.seq_len
    jc = jsteps.abstract_caches(jm, B, S)
    tc = tsteps.abstract_caches(tm, B, S)
    slots, sources = cache_slots(cfg), _layer_sources(cfg)
    for name, leaves in tc.items():
        assert all(l.device.type == "meta" for l in leaves)
    for mesh_name, mesh in MESHES.items():
        stub = StubMesh(mesh)
        got = tshd.cache_specs(tc, mesh, B)
        want = _tuples(jshd.cache_specs(jc, stub, B))
        seen = 0
        for i, ((names, j), (group, key, rep)) in enumerate(zip(slots, sources)):
            for name in names:
                ref = want[group][key][name]
                if rep is not None:  # a unit cache: the reps axis is never sharded
                    assert ref[0] is None, (mesh_name, i, name, ref)
                    ref = ref[1:]
                assert got[name][j] == ref, (mesh_name, i, name)
                assert tuple(tc[name][j].shape) == tuple(jc[group][key][name].shape)[
                    0 if rep is None else 1:]
                seen += 1
        assert seen == sum(len(v) for v in tc.values())
        assert tshd.input_specs_shardings(mesh, B, shape.kind) == \
            _tuples(jshd.input_specs_shardings(stub, B, shape.kind))


@pytest.mark.parametrize("mesh_name", sorted(MESHES))
def test_data_axes_and_choose_spec_equal_the_reference(mesh_name):
    mesh = MESHES[mesh_name]
    stub = StubMesh(mesh)
    assert tshd.data_axes(mesh) == jshd.data_axes(stub)
    rng = np.random.RandomState(3)
    for _ in range(200):
        shape = tuple(int(d) for d in rng.choice([1, 2, 3, 16, 32, 48, 160, 4096],
                                                  size=rng.randint(1, 5)))
        grouped = (tshd.data_axes(mesh),) if len(tshd.data_axes(mesh)) > 1 else ("data",)
        for axes in (("model", "data"), ("model",), ("pod",), grouped):
            assert tshd.choose_spec(shape, mesh, axes) == tuple(jshd.choose_spec(shape, stub, axes))


def test_shard_shape_rounds_up_and_sums_bytes():
    mesh = make_production_mesh(multi_pod=True)
    assert tshd.shard_shape((256, 4096), (("pod", "data"), "model"), mesh) == (8, 256)
    assert tshd.shard_shape((24, 100), ("data", None), mesh) == (2, 100)  # 24 / 16 padded to 2
    assert tshd.shard_shape((), (), mesh) == ()
    with pytest.raises(ValueError):
        tshd.shard_shape((4, 4), (None,), mesh)
    tree = {"a": torch.empty((32, 64), dtype=torch.bfloat16, device="meta"),
            "b": [torch.empty((7,), dtype=torch.float32, device="meta")]}
    specs = {"a": ("data", "model"), "b": [("model",)]}
    assert tshd.shard_bytes(tree, specs, mesh) == 2 * 4 * 2 + 1 * 4
    assert tshd.shard_bytes(tree, specs, make_host_mesh()) == 32 * 64 * 2 + 7 * 4


def test_meshes_match_the_mesh_configs():
    from repro_torch.config import MeshConfig

    for mc, mesh in ((MeshConfig.single_pod(), make_production_mesh()),
                     (MeshConfig.two_pod(), make_production_mesh(multi_pod=True)),
                     (MeshConfig.host_debug(), make_host_mesh())):
        assert Mesh.from_config(mc) == mesh
        assert mesh.size == mc.num_devices
        assert list(mesh.shape) == list(mc.axis_names)
    assert make_host_mesh(4).shape == {"data": 1, "model": 4}
    with pytest.raises(ValueError):
        Mesh(("data",), (1, 2))


def _reference_constraint(monkeypatch_ctx, mesh, shape, logical, force, tp):
    """The spec the reference's constrain hands to with_sharding_constraint."""
    seen = {}
    monkeypatch_ctx.setattr(jcons, "NamedSharding", lambda m, spec: spec)
    monkeypatch_ctx.setattr(jax.lax, "with_sharding_constraint",
                            lambda x, spec: seen.setdefault("spec", spec))
    with jcons.use_mesh(StubMesh(mesh), tp_activations=tp):
        jcons.constrain(jax.ShapeDtypeStruct(shape, np.float32), *logical, force=force)
    return tuple(seen["spec"])


LOGICAL = st.sampled_from([None, "batch", "model", "data", "pod", "seq"])
DIMS = st.sampled_from([1, 2, 3, 4, 16, 24, 32, 48, 160, 4096])


@settings(settings.get_profile("torch_sharding"))
@given(dims=st.lists(DIMS, min_size=1, max_size=4), data=st.data(),
       mesh_name=st.sampled_from(sorted(MESHES) + ["odd"]), force=st.booleans(),
       tp=st.booleans())
def test_constraint_spec_equals_the_reference(dims, data, mesh_name, force, tp):
    mesh = MESHES.get(mesh_name) or Mesh(("pod", "data", "model"), (3, 2, 4))
    logical = tuple(data.draw(st.lists(LOGICAL, min_size=len(dims), max_size=len(dims))))
    with pytest.MonkeyPatch.context() as mp:
        want = _reference_constraint(mp, mesh, tuple(dims), logical, force, tp)
    with tcons.use_mesh(mesh, tp_activations=tp):
        got = tcons.constraint_spec(tuple(dims), *logical, force=force)
    assert got == want


def test_constrain_is_the_identity_on_one_card():
    x = torch.ones(4, 8)
    assert tcons.active_mesh() is None and tcons.constraint_spec((4, 8), "batch", None) is None
    assert tcons.constrain(x, "batch", "model") is x
    mesh = make_production_mesh()
    with tcons.use_mesh(mesh, tp_activations=False):
        assert tcons.active_mesh() is mesh and not tcons.tp_activations_enabled()
        assert tcons.constrain(x, "batch", "model") is x
        assert tcons.constraint_spec((32, 64), "batch", "model") == ("data", None)
        assert tcons.constraint_spec((32, 64), "batch", "model", force=True) == ("data", "model")
        with pytest.raises(ValueError):
            tcons.constrain(x, "batch")
    assert tcons.active_mesh() is None and tcons.tp_activations_enabled()


SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")


@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_costs_equal_the_reference(arch):
    """analytic_cost, analytic_collectives, cache_bytes and model_flops_for:
    equal floats for every shape, policy, pod count and remat."""
    jcfg, tcfg = jget_config(arch), get_config(arch)
    for name in SHAPES:
        js, ts = jget_shape(name), get_shape(name)
        for remat in (True, False):
            assert trl.analytic_cost(tcfg, ts, remat=remat) == \
                jrl.analytic_cost(jcfg, js, remat=remat)
        assert trl.cache_bytes(tcfg, ts) == jrl.cache_bytes(jcfg, js)
        assert trl.model_flops_for(tcfg, ts) == jrl.model_flops_for(jcfg, js)
        for policy in ("fsdp", "tp", "replicate"):
            for pods in (1, 2):
                for tp_acts in (True, False):
                    kw = dict(policy=policy, tp_acts=tp_acts, pods=pods)
                    assert trl.analytic_collectives(tcfg, ts, **kw) == \
                        jrl.analytic_collectives(jcfg, js, **kw)


def test_roofline_report_matches_the_reference():
    """Same record keys and values under the same roofs (the reference's
    constants put into the port's spec); by default the port prices on the
    "h100" spec; COLL_FACTOR equal."""
    assert trl.COLL_FACTOR == jrl.COLL_FACTOR
    assert list(trl.no_collectives()) == list(jrl.COLL_FACTOR)
    coll = {"all-gather": 5e10, "all-reduce": 1e9, "reduce-scatter": 0, "all-to-all": 0,
            "collective-permute": 0}
    kw = dict(arch="x", shape="train_4k", mesh="pod1", chips=256, hlo_flops=1.0, hlo_bytes=2.0,
              coll_bytes=coll, model_flops=1e16, analytic_flops=1.3e16, analytic_bytes=1e12,
              analytic_coll={"total": 3e10})
    j = jrl.RooflineReport(**kw)
    spec = trl.HardwareSpec(name="ref", peak_flops=jrl.TPU_V5E.peak_flops,
                            hbm_bw=jrl.TPU_V5E.hbm_bw, ici_bw=jrl.TPU_V5E.ici_bw)
    t = trl.RooflineReport(**kw, spec=spec)
    assert t.to_dict() == j.to_dict()
    assert trl.RooflineReport(**kw).spec.name == "h100"
    zero = trl.RooflineReport(**dict(kw, coll_bytes=trl.no_collectives()))
    assert zero.coll_total == 0 and zero.t_collective == trl.H100.t_collective(3e10)
