"""Build and load the port's CUDA kernels (``csrc/*.cu``) for sm_90a.

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface, all of them at once, into ``build/kernels/<hash>/`` at
the repository root (listed in ``.gitignore``).  The hash covers every
source, header and flag, so an edited kernel is rebuilt and an unchanged
one is reused.  The libraries are loaded with ``ctypes``; every pointer and
the stream are passed as ``c_void_p``.

Nothing here runs at import: the first kernel launch calls ``load()``.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import time
import types

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("goma_gemm.cu", "goma_fused.cu", "wkv6.cu", "mamba2_ssd.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared",
              "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_long
# C signatures of the launchers (all return the launch's cudaError_t)
SIGNATURES = {
    "goma_matmul_launch": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P],
    "goma_matmul_stages": [_I],
    "goma_fused_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                          _I, _I, _P],
    "goma_combine_launch": [_P, _P, _P, _L, _I, _I, _P],
    "goma_fused_stage_bytes": [],
    "wkv6_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "wkv6_smem_bytes": [_I],
    "wkv6_ctas_per_sm": [_I],
    "ssd_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                   _I, _P],
    "ssd_smem_bytes": [_I, _I, _I],
    "ssd_ctas_per_sm": [_I, _I, _I],
    "ssd_scratch_floats": [_I, _I, _I],
}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return nvcc


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _lib_name(src: str) -> str:
    return f"lib{src.rsplit('.', 1)[0]}.so"


def _log_name(out: pathlib.Path, src: str) -> pathlib.Path:
    return out / f"{src}.ptxas.log"


@dataclasses.dataclass
class BuildReport:
    """What ``build()`` did: the library directory, the seconds nvcc took
    (0 when the libraries were already built), and nvcc's ``-Xptxas -v``
    report (registers, shared memory, spills) per source, kept beside the
    libraries."""

    path: pathlib.Path
    seconds: float = 0.0
    ptxas: dict[str, str] = dataclasses.field(default_factory=dict)


def build() -> BuildReport:
    """Compile every source in parallel (one nvcc each) unless this
    digest's libraries exist."""
    out = BUILD_ROOT / _digest()
    report = BuildReport(out)
    if all((out / _lib_name(s)).exists() for s in SOURCES):
        report.ptxas = {s: _log_name(out, s).read_text() for s in SOURCES
                        if _log_name(out, s).exists()}
        return report
    t0 = time.perf_counter()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for src in SOURCES:
        tmp = out / f"{_lib_name(src)}.{os.getpid()}.tmp"
        procs[src] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (tmp, proc) in procs.items():
        log, _ = proc.communicate()
        report.ptxas[src] = log
        _log_name(out, src).write_text(log)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{log}")
        else:
            os.replace(tmp, out / _lib_name(src))
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    report.seconds = time.perf_counter() - t0
    return report


@functools.lru_cache(maxsize=1)
def load() -> types.SimpleNamespace:
    """Build if needed, load every library, set the argtypes, and return
    one namespace holding all the launchers."""
    from ..core.hopper_mapping import STAGE_BYTES
    out = build().path
    libs = [ctypes.CDLL(str(out / _lib_name(s))) for s in SOURCES]
    ns = types.SimpleNamespace()
    for name, argtypes in SIGNATURES.items():
        fn = next(getattr(lib, name) for lib in libs if hasattr(lib, name))
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        setattr(ns, name, fn)
    # the planner budgets the fused kernel's staging beside its strips:
    # keep the two in step
    if ns.goma_fused_stage_bytes() != STAGE_BYTES:
        raise RuntimeError(f"fused-kernel staging is "
                           f"{ns.goma_fused_stage_bytes()} bytes, the "
                           f"planner assumes {STAGE_BYTES}")
    return ns


def check(err: int, what: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launcher."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
