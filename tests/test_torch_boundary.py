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


def test_the_scans_cover_every_config_module():
    """Both scans (the fresh-process import above, the file scan below)
    reach each architecture's config module."""
    names = {m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")}
    files = set(PORT.rglob("*.py"))
    for mod in ("stablelm_1_6b", "rwkv6_1_6b", "paligemma_3b", "musicgen_large", "qwen2_7b",
                "granite_3_8b", "gemma3_27b"):
        assert f"repro_torch.configs.{mod}" in names
        assert PORT / "configs" / f"{mod}.py" in files


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
