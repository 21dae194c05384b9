"""Build the port's native code into shared libraries loaded with ctypes:
the CUDA kernels of ``raytracer_tpu_torch/csrc`` with ``nvcc``, and the host
BVH library (``native/bvhtool.py``) with the C++ compiler.

The sources export plain ``extern "C"`` functions (no PyTorch headers), so a
build takes seconds. Libraries go to the gitignored
``raytracer_tpu_torch/_build/``, named by a hash of the sources, the headers
(every ``csrc/*.cuh`` for a CUDA build) and the flags: a changed source,
header or flag set builds anew, an unchanged one is reused.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from collections.abc import Callable, Sequence
from pathlib import Path

__all__ = ["build_shared", "build_library", "content_hash", "cuda_headers", "NVCC_FLAGS",
           "CSRC", "BUILD_DIR"]

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
# -fmad=false and no fast math: an FMA contraction or an approximate
# divide/sqrt shifts ulps in the slab and Möller–Trumbore math and flips
# the triangle id of razor-edge rays against the plain torch version.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME (/usr/local/cuda)")


def cuda_headers() -> list[Path]:
    """Every header of ``csrc``, sorted: what each CUDA source may include."""
    return sorted(CSRC.glob("*.cuh"))


def content_hash(sources: Sequence[Path], flags: Sequence[str], key: str = "",
                 headers: Sequence[Path] = ()) -> str:
    """Hex digest of the sources, the headers, the flags and ``key``: the
    name of the library they build."""
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.read_bytes())
    for hdr in headers:
        digest.update(hdr.name.encode() + hdr.read_bytes())
    digest.update(" ".join(flags).encode() + key.encode())
    return digest.hexdigest()


def build_shared(name: str, sources: Sequence[Path], compiler: Callable[[], str],
                 flags: Sequence[str], key: str = "",
                 headers: Sequence[Path] = ()) -> tuple[ctypes.CDLL, str]:
    """Compile ``sources`` with ``compiler()`` and ``flags`` into
    ``BUILD_DIR/<name>-<hash>.so`` unless that library exists, and load it.
    The hash (:func:`content_hash`) covers the sources, the ``headers`` they
    may include, the flags and ``key`` (for what else the output depends on,
    such as the host CPU under ``-march=native``).

    Returns (library, compiler log). Raises ``RuntimeError`` with the
    compiler's output when the compile fails."""
    out = BUILD_DIR / f"{name}-{content_hash(sources, flags, key, headers)[:16]}.so"
    log_path = out.with_suffix(".log")
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        # build to a temporary name, then rename: concurrent builders never
        # load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.run([compiler(), *flags, "-o", tmp, *map(str, sources)],
                              capture_output=True, text=True, timeout=600, check=False)
        if proc.returncode != 0:
            os.unlink(tmp)
            raise RuntimeError(f"compiling {name} failed (rc={proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        log_path.write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    log = log_path.read_text() if log_path.exists() else ""
    return ctypes.CDLL(str(out)), log


def build_library(source: str, define: str = "") -> tuple[ctypes.CDLL, str]:
    """Compile the CUDA source ``csrc/<source>`` for sm_90a (if not built
    yet) and load it; returns (library, nvcc log). ``define``: a macro set
    to 1 for this build (``-D<define>=1``), which selects a part of the
    source and names the library apart. Every ``csrc/*.cuh`` is hashed in,
    so a changed header rebuilds every kernel source."""
    flags = NVCC_FLAGS + ((f"-D{define}=1",) if define else ())
    name = Path(source).stem + (f"-{define.lower()}" if define else "")
    return build_shared(name, [CSRC / source], _nvcc, flags, headers=cuda_headers())
