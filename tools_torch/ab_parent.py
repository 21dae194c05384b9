"""A-B of this checkout's traversal kernels against another checkout's (a
parent commit unpacked with ``git archive``), on one CUDA card, in one
process.

1. The machine code: each checkout builds every library of its own
   ``csrc/traverse_rays.cu`` and ``csrc/traverse_tiles.cu`` (:func:`sources`,
   the tile kernels in the parts that checkout builds);
   ``cuobjdump -sass`` of each library is split into kernels,
   and every kernel that both checkouts build — matched by its name and
   template arguments, a batch tile kernel of this checkout by its
   arguments without its raw flag when that flag is off — is compared
   instruction by instruction (addresses and encodings dropped). It prints
   how many are identical and names the others.
2. The times: K2 with the records in device memory (``trace_rays`` with
   its defaults, which is "hbm" here) through the other checkout's wrapper
   and library and through this one's, A-B-B-A with CUDA events (other,
   this, this, other), on the waves of ``tools_torch/mb_tree_space.py``:
   config 4's hall and config 1's Cornell box at 512x512, and the dragon
   stand-in (SAH K = 32) at 1024x1024 from (0, 0, 1.15); closest-hit waves
   also with persistent warps (``scattered=True``). Then K1a on the
   dragon's framed 1920x1080 frame (``trace_tiles``), the same way.

Run from the repository root on a machine with a CUDA card:

    git archive <commit> | tar -x -C archive/parent
    python3 tools_torch/ab_parent.py archive/parent [--digests FILE]

``--digests FILE`` also writes, as JSON, the nvcc version and a SHA-256 of
the instructions of each render-core kernel that the other checkout builds
(:func:`render_core_digests`): ``chip_smoke.py``'s K1 phase holds this
checkout's render-core kernels, which every trace at K = 1 runs, against
``tools_torch/render_core_sass.json``, made so from the parent of the
change that added the per-step leaf stage of K1.
"""

from __future__ import annotations

import hashlib
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline  # noqa: E402
from raytracer_tpu_torch.ops.cuda import traverse  # noqa: E402
from raytracer_tpu_torch.utils import procgen  # noqa: E402
from tools_torch import mb_tree_space  # noqa: E402

DRAGON_SIZE, DRAGON_CAM = 1024, (0.0, 0.0, 1.15)
FRAME_W, FRAME_H, QUAT, FOV = 1920, 1080, (0.0, 0.0, 0.0, 1.0), 70.0


def load_package(root: Path, alias: str):
    """The ``raytracer_tpu_torch`` package of checkout ``root``, imported
    under the name ``alias`` (its modules import each other relatively)."""
    init = root / "raytracer_tpu_torch" / "__init__.py"
    spec = importlib.util.spec_from_file_location(alias, init,
                                                  submodule_search_locations=[str(init.parent)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[alias] = pkg
    spec.loader.exec_module(pkg)
    return pkg


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    return found or "/usr/local/cuda/bin/cuobjdump"


def sass_kernels(lib_path: str) -> dict:
    """Kernel key → its SASS instructions (text, without addresses and
    encodings), from ``cuobjdump -sass``."""
    out = subprocess.run([cuobjdump(), "-sass", lib_path], capture_output=True, text=True,
                         check=True, timeout=300).stdout
    kernels, name = {}, None
    for line in out.splitlines():
        if m := re.search(r"Function : (\S+)", line):
            name = m.group(1)
            kernels[name] = []
        elif name and (m := re.match(r"\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;", line)):
            kernels[name].append(m.group(1))
    return kernels


def kernel_key(mangled: str) -> tuple | None:
    """(kernel, template arguments) of a traversal kernel's mangled name; a
    batch tile kernel's raw flag (its fourth argument) is dropped when off,
    so that it matches a checkout without the flag."""
    m = re.search(r"((?:trace|mb)_\w+?_kernel)I((?:L[ibj]\d+E)+)E", mangled)
    if not m:
        return None
    args = re.findall(r"L([ibj]\d+)E", m.group(2))
    if m.group(1) == "trace_tiles_batch_kernel" and len(args) == 5 and args[3] == "b0":
        args = args[:3] + args[4:]
    return m.group(1), tuple(args)


# the render core's masks (csrc/traverse_core.cuh: rt::kRenderCore, with
# rt::kUnordered and rt::kSharedTree): what K1 and K2 launch at K = 1
RENDER_CORE_MASKS = (1, 9, 17, 25)


def nvcc_version() -> str:
    """The last line of ``nvcc --version``: the compiler a digest holds for."""
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    out = subprocess.run([nvcc, "--version"], capture_output=True, text=True, check=True,
                         timeout=60).stdout
    return out.strip().splitlines()[-1]


def render_core_digests(lib) -> dict:
    """"kernel<template arguments>" → SHA-256 of its SASS instructions, for
    every kernel of the loaded library ``lib`` whose core (its last
    template argument) is a form of the render core."""
    out = {}
    for mangled, sass in sass_kernels(lib._name).items():
        key = kernel_key(mangled)
        if key and int(key[1][-1][1:]) in RENDER_CORE_MASKS:
            name = f"{key[0]}<{','.join(key[1])}>"
            out[name] = hashlib.sha256("\n".join(sass).encode()).hexdigest()
    return out


def sources(traverse_module) -> tuple:
    """The libraries of a checkout's traversal kernels, as its
    ``load_kernel`` names them: the tile kernels' parts (``TILE_SOURCES``)
    and the ray kernels."""
    return (*traverse_module.TILE_SOURCES, "traverse_rays.cu")


def kernels_of(traverse_module, source: str) -> dict:
    """Kernel key → SASS instructions of every traversal kernel that the
    checkout builds from ``csrc/<source>`` (a file name; all its parts)."""
    out = {}
    for part in sources(traverse_module):
        if part.partition(":")[0] == source:
            lib = traverse_module.load_kernel(part)[0]
            out.update({kernel_key(k): v for k, v in sass_kernels(lib._name).items()
                        if kernel_key(k)})
    return out


def compare_sass(a: dict, b: dict, source: str) -> None:
    """Print how many kernels of ``source`` this checkout (``a``) and the
    other (``b``) build (:func:`kernels_of`), how many both build and how
    many of those are identical; name the others."""
    both = sorted(set(a) & set(b))
    differ = [k for k in both if a[k] != b[k]]
    print(f"[sass] {source}: {len(a)} kernels here, {len(b)} in the other; {len(both)} in "
          f"both, {len(both) - len(differ)} identical instruction for instruction; "
          f"{len(set(a) - set(b))} only in this checkout, {len(set(b) - set(a))} only in the "
          "other", flush=True)
    for k in differ:
        print(f"[sass]   differs: {k[0]}<{','.join(k[1])}> ({len(a[k])} / {len(b[k])} "
              "instructions)", flush=True)


def ab(label: str, mine, theirs, card: str, rays: int) -> None:
    """``mine()`` and ``theirs()`` equal word for word, then timed other,
    this, this, other with CUDA events; prints both and their ratio."""
    words = mb_tree_space.differing_words(mine(), theirs())
    if words:
        raise SystemExit(f"{label}: the two checkouts differ in {words} words")
    ms = {"other": [], "this": []}
    for who in ("other", "this", "this", "other"):
        ms[who].append(mb_tree_space.wave_ms(theirs if who == "other" else mine))
    a, b = (sum(v) / 2 for v in (ms["other"], ms["this"]))
    print(f"[ab] {label}: other {a:.4f} ms ({', '.join(f'{x:.4f}' for x in ms['other'])}), "
          f"this {b:.4f} ms ({', '.join(f'{x:.4f}' for x in ms['this'])}), this / other "
          f"{b / a:.4f}; planes equal on {rays} rays, on {card}", flush=True)


def main() -> None:
    if len(sys.argv) not in (2, 4) or (len(sys.argv) == 4 and sys.argv[2] != "--digests"):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_parent needs a CUDA card")
    other_root = Path(sys.argv[1]).resolve()
    other = load_package(other_root, "other_rtt")
    other_traverse = importlib.import_module("other_rtt.ops.cuda.traverse")
    dev = torch.device("cuda:0")
    card = mb_tree_space.card_line()
    print(f"[ab] this checkout against {other_root} ({other.__name__}) on {card}", flush=True)
    for source in ("traverse_rays.cu", "traverse_tiles.cu"):
        compare_sass(kernels_of(traverse, source), kernels_of(other_traverse, source), source)
    if len(sys.argv) == 4:
        digests = {source: render_core_digests(other_traverse.load_kernel(source)[0])
                   for source in ("traverse_rays.cu", "traverse_tiles.cu")}
        Path(sys.argv[3]).write_text(json.dumps(
            {"nvcc": nvcc_version(), "from": str(other_root.name), "kernels": digests},
            indent=1, sort_keys=True) + "\n")
        print(f"[sass] wrote {sum(map(len, digests.values()))} render-core digests of the "
              f"other checkout to {sys.argv[3]}", flush=True)

    trees = {label: (qn, k, mb_tree_space.waves(qn, k))
             for label, (qn, k) in mb_tree_space.trees(dev).items()}
    tris = mb_tree_space.normalized(procgen.make_dragon_stand_in())
    cs, height = build_sah2_clustered(tris.numpy(), 32, dev)
    qn = records_pipeline(cs, height=height)
    trees["dragon SAH K=32"] = (qn, 32, mb_tree_space.waves(qn, 32, DRAGON_SIZE,
                                                            cam=DRAGON_CAM))
    for label, (qn, k, ws) in trees.items():
        for name, (o, d, ah) in ws.items():
            for scattered in ((False,) if ah else (False, True)):
                kw = dict(any_hit=ah, leaf_k=k, scattered=scattered)
                ab(f"{label} {name}{' persistent' if scattered else ''}",
                   lambda kw=kw, qn=qn, o=o, d=d: traverse.trace_rays(qn, o, d, **kw),
                   lambda kw=kw, qn=qn, o=o, d=d: other_traverse.trace_rays(qn, o, d, **kw),
                   card, o.shape[0])
    qn = trees["dragon SAH K=32"][0]
    frame = dict(leaf_k=32)
    ab(f"dragon SAH K=32 K1a framed {FRAME_W}x{FRAME_H}",
       lambda: traverse.trace_tiles(qn, DRAGON_CAM, QUAT, FRAME_W, FRAME_H, FOV, **frame),
       lambda: other_traverse.trace_tiles(qn, DRAGON_CAM, QUAT, FRAME_W, FRAME_H, FOV, **frame),
       card, FRAME_W * FRAME_H)


if __name__ == "__main__":
    main()
