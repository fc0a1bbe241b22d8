"""Builds the port's CUDA kernels with ``nvcc`` and loads them with ctypes.

Each ``csrc/*.cu`` source compiles on first use (never at import) into a
shared library with a plain C interface under ``build/repro_torch_kernels/``
at the repository root.  The library's file name carries a hash of its
source, so an edited source rebuilds and an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
BUILD_DIR = PKG_DIR.parents[2] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

#: every kernel source of the port, relative to this package
SOURCES = ["flash_attention/csrc/flash_attention.cu", "checksum/csrc/checksum.cu",
           "ssm_scan/csrc/ssm_scan.cu", "selective_scan/csrc/selective_scan.cu"]

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (Path(cuda_home) / "bin" / "nvcc", shutil.which("nvcc")):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _target(source: str) -> Path:
    src = PKG_DIR / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:12]
    return BUILD_DIR / f"{src.stem}-{digest}.so"


def build(source: str) -> str:
    """Compiles ``source`` unless its library is already built.  Returns the
    compiler's output (register and shared-memory use), or ``""`` when
    nothing was compiled."""
    out = _target(source)
    if out.exists():
        return ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(PKG_DIR / source)],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stdout}")
    tmp.replace(out)  # atomic: a concurrent build sees all or nothing
    return proc.stdout


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, compiling it first if needed."""
    lib = _loaded.get(source)
    if lib is None:
        build(source)
        lib = _loaded[source] = ctypes.CDLL(str(_target(source)))
    return lib
