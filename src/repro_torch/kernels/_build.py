"""Build and load the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, loaded with ``ctypes`` (no
PyTorch headers, so a build takes seconds, not minutes). Libraries land in
``build/repro_torch/`` at the root of the checkout, named by a hash of the
sources and flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built at import: the first launch builds what it needs,
and ``build()`` builds every source at once, one ``nvcc`` per source, all
started together.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("decode_attention", "flash_attention", "batched_gemm", "grouped_gemm", "wkv6_scan")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each library's entry point: (argtypes, restype)
SIGNATURES = {
    "decode_attention": (
        # q, k, v, lengths, out, B, Hq, Hkv, S, D, dtype, variant, splits,
        # scale, stream
        [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    "flash_attention": (
        # q, k, v, out, B, Hq, Hkv, Sq, Skv, D, causal, window, q_offset,
        # dtype, variant, scale, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P], _I),
    "batched_gemm": (
        # x, w, out, R, M, N, K, dtype, variant, tile_rows, k_splits, stream
        [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "grouped_gemm": (
        # x, w, tiles, out, n_tiles, T, G, N, K, dtype, variant, stream
        [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P], _I),
    "wkv6_scan": (
        # r, k, v, w, u, s0, s_out, out, B, H, T, N, V, u_rows, strides,
        # dtype, w_f32, variant, stream
        [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _I, _I, _I, _P], _I),
}
REPRO_BAD_ARGUMENT = -1
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Kernel variants of K2 and K4, by C code: the float32 CUDA-core kernel and
# the bf16 tensor-core (wgmma + TMA) kernel. K1, K3 and K5 keep their own
# (``batched_gemm.VARIANT_CODES``, ``decode_attention.VARIANT_CODES``,
# ``wkv6_scan.VARIANT_CODES``).
VARIANT_CODES = {"cuda_core": 0, "wgmma": 1}

_loaded: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class OpCounter:
    """Per-op counts: kernel launches (in all, and by variant where the op
    has more than one kernel), and calls of the plain version."""

    launches: int = 0
    plain_calls: int = 0
    variants: Dict[str, int] = dataclasses.field(default_factory=dict)

    def launched(self, variant: str) -> None:
        """Count one launch of the op's ``variant`` kernel."""
        self.launches += 1
        self.variants[variant] = self.variants.get(variant, 0) + 1

    def reset(self) -> None:
        self.launches = 0
        self.plain_calls = 0
        self.variants = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [Path(home) / "bin" / "nvcc"] if home else []
    found = shutil.which("nvcc")
    if found:
        candidates.append(Path(found))
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    h.update(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}-{_digest(name)}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the named sources that are not built yet, in parallel.

    Returns the seconds each build took (0.0 for one already built). The
    compiler's resource report (registers, shared memory, spills) is kept
    beside each library as ``<lib>.log``. Raises with the compiler's
    output if any build fails.
    """
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    secs: Dict[str, float] = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failures = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        out.with_suffix(".log").write_text(log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, out)
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return secs


def build_log(name: str) -> str:
    """The compiler's report for a built library ('' if none)."""
    p = library_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    path = library_path(name)
    if not path.exists():
        build([name])
    lib = ctypes.CDLL(str(path))
    fn = getattr(lib, f"repro_{name}")
    fn.argtypes, fn.restype = SIGNATURES[name]
    err = getattr(lib, f"repro_{name}_error")
    err.argtypes, err.restype = [_I], ctypes.c_char_p
    _loaded[name] = lib
    return lib


def check_device(t: torch.Tensor) -> None:
    """Raise unless ``t`` lies on an sm_90 card (the kernels' only target)."""
    if not t.is_cuda:
        raise ValueError(f"kernel needs a CUDA tensor, got one on {t.device}")
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(
            f"kernels are built for sm_90a (Hopper); {torch.cuda.get_device_name(t.device)} "
            f"is sm_{cap[0]}{cap[1]}")


def check_tensor(t: torch.Tensor, what: str, dtype: Optional[torch.dtype] = None) -> None:
    """Raise unless ``t`` is contiguous, 16-byte aligned and of ``dtype``."""
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{what}: must be 16-byte aligned")


def check_status(lib: ctypes.CDLL, name: str, status: int) -> None:
    """Raise on a non-zero status from a launch (argument or CUDA error)."""
    if status == 0:
        return
    if status == REPRO_BAD_ARGUMENT:
        raise ValueError(f"{name}: arguments refused by the kernel")
    msg = getattr(lib, f"repro_{name}_error")(status).decode()
    raise RuntimeError(f"{name}: CUDA error {status} at launch: {msg}")


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream
