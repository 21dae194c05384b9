"""Traffic ``deform``: a dynamic scene seen by several cameras. Frame i's
input is the scene's triangles scaled by s = 1 + amplitude·sin(phase_step·
(k0 + i)), k0 drawn from the seed: ``prepare(i)`` makes it on the host,
outside the frame's clock, in one of two page-locked buffers (as an app that
streams vertices to the card keeps them), since ``PathTracer.refit_bvh``
takes host triangles. The frame hands them to ``refit_bvh`` (the upload, the
refit and the records) and traces ``cameras`` cameras at
(linspace(x0, x1, cameras), 0, z) with the configuration's z, looking down
−z, in one ``trace_tiles_batch`` over the refitted records; it ends when the
per-camera hit counts reach the host. Nominal rays: W·H·cameras.

Check, on each kept frame: the t and triangle planes at seeded (camera,
pixel) rays against the reference's closest hit on the scaled triangles. A
ray mismatches where the hit and the miss disagree, where t differs by more
than ``t_rtol`` of the reference's, or where the triangle differs and the
reference does not find the program's triangle at the same t (a tie).
"""

from __future__ import annotations

import numpy as np
import torch

import workcount
from reference import camera as ref_camera
from reference.intersect import Triangles, closest_hit, hit_pairs
from trafficbase import OUTPUT_BYTES, TrafficBase


class Traffic(TrafficBase):
    def __init__(self, trial) -> None:
        super().__init__(trial)
        cell = trial.cell
        z = float(trial.cfg["camera"]["position"][2])
        xs = np.linspace(*cell["camera_x"], int(cell["cameras"]))
        self.cams = [(float(x), 0.0, z) for x in xs]
        self.quats = [(0.0, 0.0, 0.0, 1.0)] * len(self.cams)
        self.amplitude = float(cell["amplitude"])
        self.phase_step = float(cell["phase_step"])
        period = int(round(2.0 * np.pi / self.phase_step))
        self.k0 = int(trial.rng.integers(0, period))
        self.tris0 = trial.session.tris
        pinned = self.device.type == "cuda"
        self.buffers = [torch.empty(self.tris0.shape, pin_memory=pinned).numpy()
                        for _ in range(2)]
        self.rays_per_frame = self.width * self.height * len(self.cams)
        self.events = []

    def scale(self, i: int) -> np.float32:
        return np.float32(1.0 + self.amplitude * np.sin(self.phase_step * (self.k0 + i)))

    def prepare(self, i: int) -> None:
        np.multiply(self.tris0, self.scale(i), out=self.buffers[i & 1])

    def frame(self, i: int):
        from raytracer_tpu_torch.ops.cuda.traverse import trace_tiles_batch

        buf = self.buffers[i & 1]
        timed = self.trial.instrument and self.device.type == "cuda"
        if timed:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
        self.pt.refit_bvh(buf)
        if timed:
            ev[1].record()
            self.events.append(ev)
        planes = trace_tiles_batch(self.pt._qnodes, self.cams, self.quats,  # noqa: SLF001
                                   self.width, self.height, self.fov, leaf_k=self.pt.leaf_size)
        return [planes, (planes[4] >= 0).sum(dim=(1, 2)), None]

    def wait(self, handle) -> None:
        handle[2] = handle[1].tolist()

    def well_formed(self, handle) -> bool:
        planes = handle[0]
        shape = (len(self.cams), self.height, self.width)
        return len(planes) == 5 and all(tuple(p.shape) == shape for p in planes)

    def keep(self, i: int, handle) -> None:
        if i in self.trial.check_frames:
            planes = handle[0]
            self.kept[i] = (planes[0].clone(), planes[4].clone())

    def collect(self) -> None:
        for ev in self.events:
            self.trial.span("refit_ms", ev[0].elapsed_time(ev[1]))
        self.events = []

    def _rays(self, idx: np.ndarray):
        per = self.width * self.height
        cam, pix = idx // per, idx % per
        px = torch.from_numpy(pix % self.width).to(self.device)
        py = torch.from_numpy(pix // self.width).to(self.device)
        d = ref_camera.primary_dirs(px, py, self.width, self.height, self.quats[0], self.fov)
        o = torch.tensor(self.cams, dtype=torch.float32, device=self.device)[
            torch.from_numpy(cam).to(self.device)]
        return o, d

    def checks(self, ref, ctl=None) -> dict:
        rtol = float(self.check["t_rtol"])
        bad = total = 0
        tris = torch.from_numpy(self.tris0).to(self.device)
        for i, (t_plane, tri_plane) in sorted(self.kept.items()):
            scaled = tris * torch.tensor(float(self.scale(i)), device=self.device)
            want_tri = Triangles(scaled)
            idx = self.pixels(i, self.rays_per_frame)
            o, d = self._rays(idx)
            t_r, i_r = closest_hit(want_tri, o, d)
            if ctl is None:
                flat = torch.from_numpy(idx).to(self.device)
                t_p, i_p = t_plane.reshape(-1)[flat], tri_plane.reshape(-1)[flat].long()
            else:
                t_p, i_p = closest_hit(Triangles(scaled, ctl.dtype), o, d)
            t_p, t_r = t_p.double(), t_r.double()
            hit_r, hit_p = i_r >= 0, i_p >= 0
            near = (t_p - t_r).abs() <= rtol * t_r.abs()
            # the program's triangle, tested alone: a tie where it is hit at t_r
            t_one, ok_one = hit_pairs(want_tri, i_p, o, d)
            tie = ok_one & ((t_one.double() - t_r).abs() <= rtol * t_r.abs())
            wrong = (hit_r != hit_p) | (hit_r & hit_p & (~near | ((i_p != i_r) & ~tie)))
            bad += int(wrong.sum())
            total += idx.size
        return {"frames_checked": len(self.kept), "hit_mismatch": bad / max(total, 1)}

    def frame_work(self, i: int, count: int) -> dict:
        """Counted on the records of the last frame traced."""
        qn, leaf_k = self.records()
        o, d = self._rays(self.pixels(-1 - i, self.rays_per_frame, count))
        k1 = workcount.Work(workcount.record_width(leaf_k, qn.shape[1]))
        workcount.traverse(qn, o.contiguous(), d, leaf_k, False, k1)
        rays = self.rays_per_frame
        return {"k1": {"flops": k1.flops() * rays / k1.rays,
                       "bytes": k1.record_bytes() + rays * OUTPUT_BYTES}}

