"""A-B of ``trace_rays``' record placements, ``tree_space`` "hbm", "vmem"
and "smem", on config 4's interior hall and on config 1's Cornell box: the
PyTorch port's counterpart of ``tools/mb_tree_space.py``.

The hall (5,250 triangles, cube-normalized, SAH K = 32) is traced at 512×512
from (0, 0, 0.8), as in the JAX tool; the Cornell box through config 1's
tree, the Morton LBVH of single triangles (``bvh2_as_bvh4(build_lbvh2(…))``,
K = 1), and through SAH K = 32. Three
waves of rays, in 32×32 tile-block lane order: "nee", any hit from the first
hits toward the sun; "bounce1", closest hit in cosine-sampled directions
from those points (the port's ``cosine_sample``, uniforms from a seeded
``torch.Generator``); "incoherent", the same rays permuted at random. The
placements run in one process in the order hbm, vmem, smem, hbm; "smem" on
the hall raises the ``ValueError`` of a tree that does not fit a block's
shared memory, which is the expected answer and is printed as such. Each
placement's planes are checked word for word against "hbm".

Run from the repository root on a machine with a CUDA card:

    python3 tools_torch/mb_tree_space.py [--size 512] [--out FILE]

It prints ms per wave and Mrays/s of each wave and placement with the card's
name and power limit, and with ``--out`` writes them as JSON.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from raytracer_tpu_torch.models.scene import Scene  # noqa: E402
from raytracer_tpu_torch.ops.camera import generate_rays  # noqa: E402
from raytracer_tpu_torch.ops.cluster import build_sah2_clustered, records_pipeline  # noqa: E402
from raytracer_tpu_torch.ops.collapse import bvh2_as_bvh4  # noqa: E402
from raytracer_tpu_torch.ops.cuda import traverse  # noqa: E402
from raytracer_tpu_torch.ops.lanes import img_to_lanes  # noqa: E402
from raytracer_tpu_torch.ops.lbvh import build_lbvh2  # noqa: E402
from raytracer_tpu_torch.ops.trace import make_wide_bvh  # noqa: E402
from raytracer_tpu_torch.ops.cuda.wave import cosine_sample  # noqa: E402
from raytracer_tpu_torch.utils import procgen  # noqa: E402

SIZE, CAM, QUAT, FOV, SEED = 512, (0.0, 0.0, 0.8), (0.0, 0.0, 0.0, 1.0), 70.0, 5
SUN = (0.48507125, 0.7276069, 0.48507125)   # normalize(1, 1.5, 1), the JAX tool's
SPACES = ("hbm", "vmem", "smem", "hbm")      # hbm twice to bracket drift
CALLS, REPEATS = 8, 3                        # launches a timed run, runs a placement


def normalized(tris) -> torch.Tensor:
    scene = Scene().set_triangles(tris)
    scene._normalize_enabled, scene._normalize_mode = True, "cube"
    scene.normalize_mesh()
    return torch.from_numpy(scene.triangles)


def trees(device) -> dict:
    """name → (records, leaf_k) of the scenes the tool traces."""
    hall = normalized(procgen.make_interior_hall())
    box = normalized(procgen.make_cornell_box())
    out = {}
    cs, height = build_sah2_clustered(hall.numpy(), 32, device)
    out["hall SAH K=32"] = (records_pipeline(cs, height=height), 32)
    box_dev = box.to(device)
    out["Cornell LBVH K=1"] = (traverse.make_qnodes(
        make_wide_bvh(bvh2_as_bvh4(build_lbvh2(box_dev))), box_dev), 1)
    cs, height = build_sah2_clustered(box.numpy(), 32, device)
    out["Cornell SAH K=32"] = (records_pipeline(cs, height=height), 32)
    return out


def waves(qn: torch.Tensor, leaf_k: int, size: int = SIZE, seed: int = SEED,
          cam=CAM) -> dict:
    """The JAX tool's three waves on records ``qn``, from camera position
    ``cam``: name → (origins, dirs, any_hit), (size², 3) f32 in tile-block
    lane order."""
    dev = qn.device
    o, d = generate_rays(size, size, cam, QUAT, FOV, device=dev)
    o = img_to_lanes(o, size, size).contiguous()
    d = img_to_lanes(d, size, size).contiguous()
    r = size * size
    t, nx, ny, nz, tri = traverse.trace_rays(qn, o, d, leaf_k=leaf_k)
    n = torch.stack([nx, ny, nz], -1)
    hit = tri >= 0
    p = (o + d * torch.where(hit, t, 0.5)[:, None] + 1e-4 * n).contiguous()
    sun = torch.tensor(SUN, dtype=torch.float32, device=dev).expand(r, 3).contiguous()
    gen = torch.Generator(device=dev).manual_seed(seed)
    u1 = torch.rand(r, generator=gen, device=dev)
    u2 = torch.rand(r, generator=gen, device=dev)
    up = torch.tensor([0.0, 0.0, 1.0], device=dev)
    db = cosine_sample(torch.where(hit[:, None], n, up), u1, u2).contiguous()
    perm = torch.randperm(r, generator=gen, device=dev)
    return {"nee": (p, sun, True), "bounce1": (p, db, False),
            "incoherent": (p[perm].contiguous(), db[perm].contiguous(), False)}


def wave_ms(fn, calls: int = CALLS, repeats: int = REPEATS) -> float:
    """Median CUDA-event ms of one call of ``fn`` over ``repeats`` runs of
    ``calls`` calls, after a warm-up call."""
    fn()
    torch.cuda.synchronize()
    reps = []
    for _ in range(repeats):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        reps.append(start.elapsed_time(end) / calls)
    return statistics.median(reps)


def differing_words(a, b) -> int:
    return sum(int((x.reshape(-1).view(torch.int32) != y.reshape(-1).view(torch.int32)).sum())
               for x, y in zip(a, b))


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip().splitlines()[0]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=SIZE, help="frame side of the waves (pixels)")
    ap.add_argument("--out", help="write the numbers as JSON to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mb_tree_space needs a CUDA card")
    dev = torch.device("cuda:0")
    card = card_line()
    limits = traverse.tree_space_limits(dev)
    print(f"card: {card}; limits {json.dumps(limits)}", flush=True)
    results = []
    for label, (qn, k) in trees(dev).items():
        nbytes = qn.numel() * 4
        print(f"{label}: records {tuple(qn.shape)} = {nbytes} bytes", flush=True)
        ws = waves(qn, k, args.size)
        r = args.size * args.size
        base = {name: traverse.trace_rays(qn, o, d, any_hit=ah, leaf_k=k)
                for name, (o, d, ah) in ws.items()}
        for space in SPACES:
            for name, (o, d, ah) in ws.items():
                def call(space=space, o=o, d=d, ah=ah):
                    return traverse.trace_rays(qn, o, d, any_hit=ah, leaf_k=k, tree_space=space)
                try:
                    words = differing_words(call(), base[name])
                except ValueError as exc:
                    print(f"space={space:4s} {label} {name:10s} refused: {exc}", flush=True)
                    results.append({"tree": label, "space": space, "wave": name,
                                    "refused": str(exc)})
                    continue
                ms = wave_ms(call)
                print(f"space={space:4s} {label} {name:10s} {ms:8.4f} ms/wave "
                      f"{r / ms / 1e3:8.2f} Mrays/s, {words} words differ from hbm, on {card}",
                      flush=True)
                if words:
                    raise SystemExit(f"{label} {name}: tree_space={space} differs from hbm")
                results.append({"tree": label, "space": space, "wave": name, "ms": ms,
                                "mrays_s": r / ms / 1e3, "bytes": nbytes})
    if args.out:
        Path(args.out).write_text(json.dumps({"card": card, "limits": limits, "size": args.size,
                                              "results": results}, indent=1))


if __name__ == "__main__":
    main()
