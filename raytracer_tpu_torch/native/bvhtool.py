"""ctypes binding for the native BVH tooling of ``raytracer_tpu/native``.

The port uses the JAX package's C++ sources unchanged: the binned-SAH
cluster build (``sah_build.cpp``) and the greedy BVH2 → BVH4 collapse
(``bvh_convert.cpp``). :func:`ensure_built` compiles them at first use into
the port's gitignored build directory, without importing the JAX package.
It does not run the JAX package's ``build.sh``: that script links with
``-flto``, which fails where the linker cannot run GCC's LTO plugin, and it
writes the ``lib/libbvhtool.so`` the JAX package loads. The flags are
otherwise build.sh's, ``-march=native`` included: it lets GCC contract
multiply-adds in the SAH cost, which changes some split decisions, so the
same flags give the same trees as the JAX package's library on one host.
"""

from __future__ import annotations

import ctypes
import os
import platform
import shutil
from pathlib import Path

import numpy as np

from ..ops.cuda.build import build_shared

__all__ = ["ensure_built", "build_sah_clustered_native", "collapse4_native"]

_NATIVE_SRC = Path(__file__).resolve().parents[2] / "raytracer_tpu" / "native"
# build.sh's flags without -flto (see the module docstring)
CXX_FLAGS = ("-std=c++20", "-O3", "-march=native", "-Wall", "-shared", "-fPIC")
NODE4_STRIDE = 8

_u32p = ctypes.POINTER(ctypes.c_uint32)
_lib: ctypes.CDLL | None = None


def _host_cpu() -> str:
    """The CPU model, which ``-march=native`` output depends on."""
    cpuinfo = Path("/proc/cpuinfo")
    if cpuinfo.exists():
        for line in cpuinfo.read_text().splitlines():
            if line.startswith("model name"):
                return line
    return platform.machine()


def _cxx() -> str:
    cxx = os.environ.get("CXX", "g++")
    found = shutil.which(cxx)
    if found is None:
        raise RuntimeError(f"C++ compiler {cxx!r} not found (set CXX)")
    return found


def ensure_built() -> ctypes.CDLL:
    """Build (at first use) and load the native BVH library. Raises
    ``RuntimeError`` with the compiler output if the build fails."""
    global _lib
    if _lib is None:
        lib, _ = build_shared("libbvhtool", [_NATIVE_SRC / "bvh_convert.cpp",
                                             _NATIVE_SRC / "sah_build.cpp"], _cxx, CXX_FLAGS,
                              key=_host_cpu())
        lib.bvh_build_sah_clustered.restype = ctypes.c_uint32
        lib.bvh_build_sah_clustered.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_uint32, ctypes.c_uint32,
        ] + [_u32p] * 6
        lib.bvh_collapse4.restype = ctypes.c_uint32
        lib.bvh_collapse4.argtypes = [_u32p, _u32p]
        _lib = lib
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_u32p)


def build_sah_clustered_native(tris: np.ndarray, leaf_size: int) -> tuple[dict, np.ndarray, int]:
    """Binned-SAH build whose leaves are clusters of exactly ``leaf_size``
    triangles (except the global tail): cluster c is
    ``order[cK, min((c+1)K, n))``.

    Returns ({bounds,left,right,meta,parent} sized 2·ceil(n/K)−1,
    order (n,) u32, height)."""
    lib = ensure_built()
    tris = np.ascontiguousarray(tris, dtype=np.float32).reshape(-1, 9)
    n = len(tris)
    k = max(int(leaf_size), 1)
    nc = max(-(-n // k), 1)
    m = max(2 * nc - 1, 1)
    arrays = {"bounds": np.zeros((m, 3), dtype=np.uint32)}
    for name in ("left", "right", "meta", "parent"):
        arrays[name] = np.zeros(m, dtype=np.uint32)
    order = np.zeros(n, dtype=np.uint32)
    height = int(lib.bvh_build_sah_clustered(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n, k,
        _ptr(arrays["bounds"]), _ptr(arrays["left"]), _ptr(arrays["right"]),
        _ptr(arrays["meta"]), _ptr(arrays["parent"]), _ptr(order)))
    return arrays, order, height


def collapse4_native(bvh2_buf: np.ndarray) -> np.ndarray:
    """BVH2 image → collapsed BVH4 image (greedy re-emission collapse),
    trimmed to the emitted node count."""
    lib = ensure_built()
    bvh2_buf = np.ascontiguousarray(bvh2_buf, dtype=np.uint32)
    m = int(bvh2_buf[0])
    out = np.zeros(1 + m * NODE4_STRIDE, dtype=np.uint32)
    n4 = int(lib.bvh_collapse4(_ptr(bvh2_buf), _ptr(out)))
    return out[: 1 + n4 * NODE4_STRIDE]
