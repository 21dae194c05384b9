"""K1's cores on one CUDA card, apart from the rest of ``chip_smoke.py``:
its K1 phase (``chip_smoke.k1_phase``) on the trees it needs, built here.

It times the render core (``core="order"``), the per-step choice of leaf
stage (``traverse.TILE_CORE``) and the frozen loop (``core="baseline"``)
in one process, forward and back, with every plane bit-identical, and logs
each case's warp census (what each warp step posts, priced for both leaf
stages): K1a framed and sparse on the dragon stand-in at SAH K = 32, K1b's
camera wave, one 8-camera K1c batch of the dynamic dragon's refitted
records, config 5's K1c raw, the Cornell box at SAH K = 32, Morton K = 8,
the 8-wide tree and K1f; then the headline frame, one 3-bounce sample and
the dynamic dragon frame with only K1 swapped, A-B-B-A.

Run from the repository root on a machine with a CUDA card:

    python3 tools_torch/ab_tiles.py
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402


def main() -> None:
    if len(sys.argv) > 1:
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("ab_tiles needs a CUDA card")
    from raytracer_tpu_torch import PathTracer, Scene
    from raytracer_tpu_torch.ops.cluster import build_sah2_clustered
    from raytracer_tpu_torch.ops.collapse import collapse_plan
    from raytracer_tpu_torch.utils import procgen
    from tools_torch import mb_tree_space

    dev = torch.device("cuda:0")
    card = smoke.card_line()
    smoke.log(f"[ab_tiles] on {card} | torch {torch.__version__}")
    smoke.build_all()
    glb = ROOT / "data" / "dragon_standin.glb"
    if not glb.exists():
        glb.parent.mkdir(parents=True, exist_ok=True)
        procgen.write_glb(glb, procgen.make_dragon_stand_in())
    scene = Scene().load_glb(glb, normalize=True, mode="cube")
    t0 = time.perf_counter()
    pt = PathTracer(smoke.WIDTH, smoke.HEIGHT, builder="sah", leaf_size=smoke.LEAF_K, device=dev)
    pt.set_scene(scene)
    r0, c0 = (smoke.HEIGHT - smoke.CROP) // 2, (smoke.WIDTH - smoke.CROP) // 2
    rows = torch.arange(r0, r0 + smoke.CROP, device=dev)
    cols = torch.arange(c0, c0 + smoke.CROP, device=dev)
    env = {"qn": pt._qnodes, "tris": pt._tris_dev, "card": card, "dev": dev,
           "crop_pix": (rows[:, None] * smoke.WIDTH + cols[None, :]).reshape(-1)}

    # the dynamic dragon (phase 13's chain): frame 2's refitted records
    height = pt._bvh2_height + 2
    cs = smoke.device_topology(pt._cluster, dev)
    cams, quats = smoke.batch_cameras(smoke.CAM_Z)
    refit, records, _, frame = smoke.refit_chain(cs, collapse_plan(cs.bvh2, sweeps=height),
                                                 height, env["tris"], cams, quats,
                                                 (smoke.WIDTH, smoke.HEIGHT))
    env["dynamic_qn"], env["dynamic_frame"] = records(refit(2)), frame

    # config 5 (phase 14): icosphere(4) at SAH K = 32, frame 3's records
    ico = Scene().set_triangles(procgen.make_icosphere(4))
    ico._normalize_enabled, ico._normalize_mode = True, "cube"
    ico.normalize_mesh()
    cs5, h5 = build_sah2_clustered(ico.triangles, smoke.LEAF_K, dev)
    cs5 = smoke.device_topology(cs5, dev)
    cams5, quats5 = smoke.batch_cameras(smoke.CONFIG5_Z)
    refit5, records5, _, _ = smoke.refit_chain(
        cs5, collapse_plan(cs5.bvh2, sweeps=h5 + 2), h5 + 2,
        torch.from_numpy(ico.triangles).to(dev), cams5, quats5,
        (smoke.CONFIG5_SIZE, smoke.CONFIG5_SIZE))
    env["config5"] = (records5(refit5(3)), cams5, quats5)
    env["cornell32"] = mb_tree_space.trees(dev)["Cornell SAH K=32"][0]

    trees_of = {}
    for key, kw in ((8, dict(builder="lbvh", leaf_size=8)),
                    ("8-wide", dict(builder="sah", leaf_size=smoke.LEAF_K, widener="collapse8"))):
        other = PathTracer(smoke.WIDTH, smoke.HEIGHT, device=dev, **kw)
        other.set_scene(scene)
        trees_of[key] = (other._qnodes, kw["leaf_size"], str(key))
        del other
    smoke.log(f"[ab_tiles] trees built in {time.perf_counter() - t0:.1f} s")
    smoke.k1_phase(env, trees_of)
    smoke.log(card)


if __name__ == "__main__":
    main()
