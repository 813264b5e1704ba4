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

pytest.importorskip("torch")
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
        assert top not in ("jax", "jaxlib", "repro"), f"{path} imports {name}"


def test_stablelm_config_equals_the_jax_package():
    want = jconfig.get_config("stablelm-1.6b")
    got = tconfig.get_config("stablelm-1.6b")
    assert _plain(got) == _plain(want)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    assert (got.num_layers, got.d_model, got.num_heads, got.num_kv_heads, got.d_ff,
            got.vocab_size, got.source) == (24, 2048, 32, 32, 5632, 100352,
                                            "hf:stabilityai/stablelm-2-1_6b")
    assert got.param_count() == want.param_count()


def test_smoke_variant_equals_the_jax_package():
    want = jconfig.smoke_variant(jconfig.get_config("stablelm-1.6b"))
    got = tconfig.smoke_variant(tconfig.get_config("stablelm-1.6b"))
    assert _plain(got) == _plain(want)


def test_rwkv_config_and_smoke_variant_equal_the_jax_package():
    want = jconfig.get_config("rwkv6-1.6b")
    got = tconfig.get_config("rwkv6-1.6b")
    assert _plain(got) == _plain(want)
    assert (got.num_layers, got.d_model, got.d_ff, got.vocab_size, got.ssm.head_dim,
            got.source) == (24, 2048, 7168, 65536, 64, "arXiv:2404.05892")
    assert got.param_count() == want.param_count()
    assert _plain(tconfig.smoke_variant(got)) == _plain(jconfig.smoke_variant(want))


def test_schedule_config_equals_the_jax_package():
    assert _plain(tconfig.ScheduleConfig()) == _plain(jconfig.ScheduleConfig())
    kw = dict(batching_policy="edf", preemption=True, admission_policy="feasibility",
              oversubscription=1.5, max_pending_per_tenant=4)
    assert _plain(tconfig.ScheduleConfig(**kw)) == _plain(jconfig.ScheduleConfig(**kw))


def test_registry_lists_only_ported_archs():
    from repro_torch.configs import PORTED_ARCHS

    assert tconfig.list_configs() == ["rwkv6-1.6b", "stablelm-1.6b"]
    assert sorted(PORTED_ARCHS) == tconfig.list_configs()
    with pytest.raises(KeyError, match="unknown arch"):
        tconfig.get_config("gemma3-27b")


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
