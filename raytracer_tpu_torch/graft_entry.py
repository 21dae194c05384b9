"""Driver entry points: the single-card forward step and the multi-card dry
run — the counterparts of the JAX package's ``__graft_entry__.py``.

entry()               → (forward, example_args): one 64×64 Lambert frame of
                        the small scene through ``render.render_ldr``.
dryrun_multichip(n)   → n ranks (``parallel.mesh.run_ranks``) run every
                        sharding of ``parallel/mesh.py`` once at the JAX dry
                        run's shapes: row bands, spp, a camera batch and
                        path-traced samples.

Both run on the card unless given ``device="cpu"``.
"""

from __future__ import annotations

import numpy as np
import torch

CAM_POS = (0.0, 0.0, 3.5)
CAM_QUAT = (0.0, 0.0, 0.0, 1.0)


def _small_scene(device):
    """The JAX ``_small_scene``: the icosphere(1) LBVH, collapsed 4-wide →
    (wide nodes, triangles) on ``device``."""
    from .ops.collapse import collapse_lbvh2_to_bvh4
    from .ops.lbvh import build_lbvh2
    from .ops.trace import make_wide_bvh
    from .utils import procgen

    tris = torch.from_numpy(procgen.make_icosphere(1)).to(device)
    return make_wide_bvh(collapse_lbvh2_to_bvh4(build_lbvh2(tris))), tris


def entry(device="cuda"):
    """Forward render step + example args (one card): ``forward(wide, tris,
    cam_pos, cam_quat)`` → rgb (64, 64, 3) f32 on ``device``."""
    from .render import render_ldr

    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but no CUDA device is available")
    wide, tris = _small_scene(dev)

    def forward(wide, tris, cam_pos, cam_quat):
        rgb, _, _ = render_ldr(wide, tris, cam_pos, cam_quat, 64, 64)
        return rgb

    return forward, (wide, tris, CAM_POS, CAM_QUAT)


def _dryrun_rank(mesh) -> str:
    """One rank of :func:`dryrun_multichip`: every sharding once, checked
    for shape and finite values → a one-line summary."""
    from .ops.cuda.traverse import make_qnodes
    from .parallel.mesh import (render_cameras_sharded, render_pt_spp_sharded,
                                render_spp_sharded, render_tiles_sharded)

    n = mesh.size
    wide, tris = _small_scene(mesh.device)
    qn = make_qnodes(wide, tris)
    h, w = 8 * n, 32  # one 8-row band per rank
    rgb, _, _ = render_tiles_sharded(qn, tris, CAM_POS, CAM_QUAT, w, h, mesh)
    seeds = list(range(n))
    acc = render_spp_sharded(qn, tris, CAM_POS, CAM_QUAT, seeds, w, h, mesh)
    # the JAX dry run's Pallas band: 64 rows a rank
    rgb_p, _, _ = render_tiles_sharded(qn, tris, CAM_POS, CAM_QUAT, 64, 64 * n, mesh)
    n_cam = 2 * n
    poss = np.tile(np.float32(CAM_POS), (n_cam, 1))
    poss[:, 0] = np.linspace(-0.2, 0.2, n_cam)
    quats = np.tile(np.float32(CAM_QUAT), (n_cam, 1))
    cams = render_cameras_sharded(qn, tris, poss, quats, w, 8, mesh)
    acc_pt = render_pt_spp_sharded(qn, tris, CAM_POS, CAM_QUAT, seeds, 16, 16, mesh, bounces=2)
    shapes = {"tiles": (rgb, (h, w, 3)), "spp": (acc, (h, w, 3)),
              "band": (rgb_p, (64 * n, 64, 3)), "cameras": (cams, (n_cam, 8, w, 3)),
              "pt": (acc_pt, (16, 16, 3))}
    for name, (a, shape) in shapes.items():
        if tuple(a.shape) != shape or not bool(torch.isfinite(a).all()):
            raise AssertionError(f"{name}: {tuple(a.shape)} (want {shape}) or not finite")
    return (f"dryrun_multichip({n}) rank {mesh.rank} on {mesh.device}: tile-sharded "
            f"{tuple(rgb.shape)} + spp-mean {tuple(acc.shape)} + band {tuple(rgb_p.shape)} + "
            f"cameras-sharded {tuple(cams.shape)} + pt-spp-mean {tuple(acc_pt.shape)} OK")


def dryrun_multichip(n_devices: int, device="cuda", backend: str | None = None) -> list[str]:
    """One full multi-card step over ``n_devices`` ranks at tiny shapes: the
    scene replicated, pixel row bands sharded, spp sharded with an
    all-reduce mean, a camera batch sharded and path-traced samples. The
    backend defaults to NCCL on cards (one card a rank: more ranks than
    visible cards raise) and gloo on the CPU. Returns each rank's summary."""
    from .parallel.mesh import run_ranks

    lines = run_ranks(_dryrun_rank, n_devices, device=device, backend=backend)
    for line in lines:
        print(line)
    return lines
