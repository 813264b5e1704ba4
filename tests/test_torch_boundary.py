"""The port stands alone: ``repro_torch`` imports neither jax nor ``repro``,
and its own copies of the configs equal the JAX package's field by field."""

import ast
import dataclasses
import enum
import os
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # one thread: pytest's workers already fill every core
pytest.importorskip("jax")

import repro.config as jconfig  # noqa: E402
import repro.configs.paper_sgemm as jsgemm  # noqa: E402

import repro_torch  # noqa: E402
import repro_torch.config as tconfig  # noqa: E402
import repro_torch.configs.paper_sgemm as tsgemm  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _plain(value):
    """Dataclass fields as comparable plain values (enums by value)."""
    if isinstance(value, enum.Enum):
        return value.value
    if dataclasses.is_dataclass(value):
        return {f.name: _plain(getattr(value, f.name)) for f in dataclasses.fields(value)}
    if isinstance(value, tuple):
        return tuple(_plain(v) for v in value)
    return value


def test_importing_every_module_loads_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(len(names), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n = int(out.stdout.split()[0])
    assert n == len(list(pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")))
    assert n >= 20


def test_the_scans_cover_every_config_module():
    """Both scans (the fresh-process import above, the file scan below)
    reach each architecture's config module."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    files = set(PORT.rglob("*.py"))
    for mod in ("stablelm_1_6b", "rwkv6_1_6b", "paligemma_3b", "musicgen_large", "qwen2_7b",
                "granite_3_8b", "gemma3_27b"):
        assert f"repro_torch.configs.{mod}" in names
        assert PORT / "configs" / f"{mod}.py" in files


def test_the_scans_cover_the_control_plane():
    """The package walk and the file scan reach every control-plane module
    of the port: the pump, the simulators, the recorder, the partition
    shares, knee and planner, the hardware spec, the live fleet, the API,
    the CLI and the HTTP front door."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    files = set(PORT.rglob("*.py"))
    for mod in ("core.pump", "sim.traces", "sim.router", "sim.costmodel", "sim.metrics",
                "sim.simulator", "sim.autoscale", "sim.fleet", "sim.shard", "obs.recorder",
                "obs.telemetry", "obs.trace_export", "partition.shares", "partition.knee",
                "partition.planner", "launch.roofline", "launch.serve", "serving.fleet",
                "api.report", "api.spec", "api.build", "api.cli", "__main__"):
        assert f"repro_torch.{mod}" in names
        assert PORT / (mod.replace(".", "/") + ".py") in files
    for pkg in ("sim", "obs", "partition", "launch", "api"):
        assert f"repro_torch.{pkg}" in names


def test_the_scans_cover_the_training_path():
    """The package walk and the file scan reach the training package (its
    optimizer, data stream, checkpoint file and train loop) and the train
    launcher, so neither may import jax, msgpack or anything of repro."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    files = set(PORT.rglob("*.py"))
    for mod in ("training.optimizer", "training.data", "training.checkpoint",
                "training.train_loop", "launch.train"):
        assert f"repro_torch.{mod}" in names
        assert PORT / (mod.replace(".", "/") + ".py") in files
    assert "repro_torch.training" in names
    assert PORT / "training" / "__init__.py" in files


def test_the_scans_cover_distributed_and_the_dry_run():
    """The package walk and the file scan reach the sharding rules, the
    constraints, the meshes, the step builders, the dry run and the shape
    and runtime configs, so none may import jax or anything of repro."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    files = set(PORT.rglob("*.py"))
    for mod in ("distributed.sharding", "distributed.constraints", "launch.mesh",
                "launch.steps", "launch.dryrun", "config.shapes", "config.runtime"):
        assert f"repro_torch.{mod}" in names
        assert PORT / (mod.replace(".", "/") + ".py") in files
    assert "repro_torch.distributed" in names
    assert PORT / "distributed" / "__init__.py" in files


def test_the_scans_cover_the_decode_programs():
    """The package walk and the file scan reach the engine's decode
    programs (CUDA graphs of the decode steps), so they may import neither
    jax nor anything of repro."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    files = set(PORT.rglob("*.py"))
    assert "repro_torch.serving.graphs" in names
    assert PORT / "serving" / "graphs.py" in files


def test_the_scans_cover_the_examples_and_the_train_program():
    """The package walk (the fresh-process import above) and the file scan
    reach the six example scripts and the captured train step, so none may
    import jax, msgpack or anything of repro."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    files = set(PORT.rglob("*.py"))
    for mod in ("examples.quickstart", "examples.policy_sweep", "examples.fleet_routing",
                "examples.spacetime_ablation", "examples.multi_tenant_serving",
                "examples.train_small", "training.graphs"):
        assert f"repro_torch.{mod}" in names
        assert PORT / (mod.replace(".", "/") + ".py") in files
    assert "repro_torch.examples" in names
    assert PORT / "examples" / "__init__.py" in files
    reference = sorted(p.stem for p in (ROOT / "examples").glob("*.py"))
    assert reference == sorted(p.stem for p in (PORT / "examples").glob("*.py")
                               if p.stem != "__init__")


def test_dryrun_help_runs_with_jax_unimportable():
    """``python -m repro_torch.launch.dryrun --help`` in a fresh interpreter
    in which jax and the reference package cannot be imported."""
    code = ("import runpy, sys\n"
            "sys.modules['jax'] = sys.modules['repro'] = None\n"
            "sys.argv = ['python -m repro_torch.launch.dryrun', '--help']\n"
            "runpy.run_module('repro_torch.launch.dryrun', run_name='__main__', "
            "alter_sys=True)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "{pod1,pod2,host}" in out.stdout


@pytest.mark.parametrize("mod", ["training", "training.checkpoint", "training.graphs",
                                 "launch.train", "examples.train_small"])
def test_training_modules_import_neither_msgpack_nor_jax(mod):
    """The checkpoint writes the reference's msgpack file itself: importing
    the training path loads no msgpack (the card's machine has none)."""
    code = (
        "import importlib, sys\n"
        f"importlib.import_module('repro_torch.{mod}')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro', 'msgpack'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_the_hardware_registry_holds_no_tpu_part():
    from repro_torch.launch import roofline

    names = list(roofline.HARDWARE_SPECS) + [s.name for s in roofline.HARDWARE_SPECS.values()]
    assert names and not any("v5e" in n or "tpu" in n for n in names)
    assert roofline.HardwareSpec().name == "h100"


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_imports_jax_or_repro(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "repro", "msgpack"), f"{path} imports {name}"


# Each ported architecture's headline fields, as its source states them:
# (layers, d_model, heads, kv heads, head dim (attention's, or rwkv6's
# SSM head), d_ff, vocab, source).
PORTED = {
    "stablelm-1.6b": (24, 2048, 32, 32, 64, 5632, 100352, "hf:stabilityai/stablelm-2-1_6b"),
    "rwkv6-1.6b": (24, 2048, 0, 0, 64, 7168, 65536, "arXiv:2404.05892"),
    "paligemma-3b": (18, 2048, 8, 1, 256, 16384, 257216, "arXiv:2407.07726"),
    "musicgen-large": (48, 2048, 32, 32, 64, 8192, 2048, "arXiv:2306.05284"),
    "qwen2-7b": (28, 3584, 28, 4, 128, 18944, 152064, "arXiv:2407.10671"),
    "granite-3-8b": (40, 4096, 32, 8, 128, 12800, 49155, "hf:ibm-granite/granite-3.0-2b-base"),
    "gemma3-27b": (62, 5376, 32, 16, 128, 21504, 262144, "hf:google/gemma-3-1b-pt"),
    "granite-moe-1b-a400m": (24, 1024, 16, 8, 64, 512, 49155,
                             "hf:ibm-granite/granite-3.0-1b-a400m-base"),
    "zamba2-7b": (81, 3584, 32, 32, 112, 14336, 32000, "arXiv:2411.15242"),
    "llama4-maverick-400b-a17b": (48, 5120, 40, 8, 128, 8192, 202048,
                                  "hf:meta-llama/Llama-4-Scout-17B-16E"),
}


@pytest.mark.parametrize("arch", sorted(PORTED))
def test_config_and_smoke_variant_equal_the_jax_package(arch):
    """The port's copy of each config equals the reference's field by field
    (same fields, same order, same values, same parameter count), and so do
    their smoke variants, at 2 layers and at 6 (gemma3's first global
    layer)."""
    want = jconfig.get_config(arch)
    got = tconfig.get_config(arch)
    assert _plain(got) == _plain(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    head_dim = got.head_dim or got.ssm.head_dim
    assert (got.num_layers, got.d_model, got.num_heads, got.num_kv_heads, head_dim,
            got.d_ff, got.vocab_size, got.source) == PORTED[arch]
    assert got.param_count() == want.param_count()
    for n in (2, 6):
        assert _plain(tconfig.smoke_variant(got, num_layers=n)) == \
            _plain(jconfig.smoke_variant(want, num_layers=n))


def test_schedule_config_equals_the_jax_package():
    assert _plain(tconfig.ScheduleConfig()) == _plain(jconfig.ScheduleConfig())
    kw = dict(batching_policy="edf", preemption=True, admission_policy="feasibility",
              oversubscription=1.5, max_pending_per_tenant=4)
    assert _plain(tconfig.ScheduleConfig(**kw)) == _plain(jconfig.ScheduleConfig(**kw))


def test_input_shapes_equal_the_jax_package():
    assert list(tconfig.INPUT_SHAPES) == list(jconfig.INPUT_SHAPES)
    for name, want in jconfig.INPUT_SHAPES.items():
        got = tconfig.get_shape(name)
        assert [f.name for f in dataclasses.fields(got)] == \
            [f.name for f in dataclasses.fields(want)]
        assert _plain(got) == _plain(want) and got.is_decode == want.is_decode
    with pytest.raises(KeyError, match="unknown input shape"):
        tconfig.get_shape("not-a-shape")


def test_mesh_and_runtime_configs_equal_the_jax_package():
    for ctor in ("single_pod", "two_pod", "host_debug"):
        got, want = getattr(tconfig.MeshConfig, ctor)(), getattr(jconfig.MeshConfig, ctor)()
        assert _plain(got) == _plain(want)
        assert (got.num_devices, got.multi_pod) == (want.num_devices, want.multi_pod)
    assert _plain(tconfig.MeshConfig()) == _plain(jconfig.MeshConfig())
    for cls in ("MeshConfig", "RuntimeConfig"):
        assert [f.name for f in dataclasses.fields(getattr(tconfig, cls))] == \
            [f.name for f in dataclasses.fields(getattr(jconfig, cls))]
    assert _plain(tconfig.RuntimeConfig()) == _plain(jconfig.RuntimeConfig())
    kw = dict(arch="rwkv6-1.6b", shape="decode_32k", num_tenants=4, remat="none")
    assert _plain(tconfig.RuntimeConfig(mesh=tconfig.MeshConfig.two_pod(), **kw)) == \
        _plain(jconfig.RuntimeConfig(mesh=jconfig.MeshConfig.two_pod(), **kw))


def test_registry_lists_only_ported_archs():
    from repro_torch.configs import PORTED_ARCHS

    from repro.configs import ASSIGNED_ARCHS

    assert len(PORTED_ARCHS) == 10 and sorted(PORTED_ARCHS) == sorted(PORTED)
    assert sorted(PORTED_ARCHS) == sorted(ASSIGNED_ARCHS) == tconfig.list_configs()
    with pytest.raises(KeyError, match="unknown arch"):
        tconfig.get_config("not-an-arch")


def test_paper_sgemm_equals_the_jax_package():
    assert list(tsgemm.PAPER_GEMM_SHAPES) == list(jsgemm.PAPER_GEMM_SHAPES)
    for name, want in jsgemm.PAPER_GEMM_SHAPES.items():
        got = tsgemm.PAPER_GEMM_SHAPES[name]
        assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
        assert _plain(got) == _plain(want)
        assert got.flops == want.flops
    assert tsgemm.PAPER_R_SWEEP == jsgemm.PAPER_R_SWEEP


def test_every_cuda_source_has_a_build_entry():
    sources = sorted(p.stem for p in (PORT / "kernels" / "csrc").glob("*.cu"))
    assert sources == sorted(_build.SOURCES)
    assert sorted(_build.SIGNATURES) == sources
