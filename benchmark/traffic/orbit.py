"""Traffic ``orbit``: the interactive viewer. Each frame is one
``PathTracer.render()`` from a camera on a circle about the scene's centre,
looking at it; the camera advances ``step_degrees`` a frame from an angle
drawn from the seed. Nominal rays: W·H (one primary ray a pixel).

Check: the rgba8 frames kept from the window against the reference's
shading of the same pixels; a pixel mismatches where a channel differs by
more than ``pixel_levels``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import workcount
from reference import camera as ref_camera
from reference import render as ref_render
from trafficbase import OUTPUT_BYTES, TrafficBase, orbit_camera


class Traffic(TrafficBase):
    def __init__(self, trial) -> None:
        super().__init__(trial)
        cell = trial.cell
        self.radius = float(np.linalg.norm(trial.cfg["camera"]["position"]))
        self.step = math.radians(float(cell["step_degrees"]))
        self.theta0 = float(trial.rng.uniform(0.0, 2.0 * math.pi))
        self.rays_per_frame = self.width * self.height

    def camera(self, i: int):
        return orbit_camera(self.radius, self.theta0 + i * self.step)

    def frame(self, i: int):
        pos, quat = self.camera(i)
        self.pt.set_camera_position(*pos)
        self.pt.set_camera_quaternion(*quat)
        return self.pt.render()

    def well_formed(self, img) -> bool:
        return tuple(img.shape) == (self.height, self.width, 4) and img.dtype == torch.uint8

    def keep(self, i: int, img) -> None:
        if i in self.trial.check_frames:
            self.kept[i] = img.clone()

    def checks(self, ref, ctl=None) -> dict:
        bad = total = 0
        for i, img in sorted(self.kept.items()):
            pos, quat = self.camera(i)
            idx = self.pixels(i)
            px = torch.from_numpy(idx % self.width).to(self.device)
            py = torch.from_numpy(idx // self.width).to(self.device)
            want = ref_render.shade_pixels(ref, pos, quat, self.width, self.height, self.fov,
                                           px, py)
            got = (img[py, px] if ctl is None else
                   ref_render.shade_pixels(ctl, pos, quat, self.width, self.height, self.fov,
                                           px, py))
            diff = (got.int() - want.int()).abs().amax(dim=-1)
            bad += int((diff > int(self.check["pixel_levels"])).sum())
            total += idx.size
        return {"frames_checked": len(self.kept), "pixel_mismatch": bad / max(total, 1)}

    def frame_work(self, i: int, count: int) -> dict:
        qn, leaf_k = self.records()
        pos, quat = self.camera(i)
        idx = self.pixels(-1 - i, count=count)
        px = torch.from_numpy(idx % self.width).to(self.device)
        py = torch.from_numpy(idx // self.width).to(self.device)
        d = ref_camera.primary_dirs(px, py, self.width, self.height, quat, self.fov)
        o = torch.as_tensor(pos, dtype=torch.float32, device=self.device).expand_as(d)
        k1 = workcount.Work(workcount.record_width(leaf_k, qn.shape[1]))
        workcount.traverse(qn, o.contiguous(), d, leaf_k, False, k1)
        rays = self.rays_per_frame
        scale = rays / k1.rays
        return {"k1": {"flops": k1.flops() * scale,
                       "bytes": k1.record_bytes() + rays * OUTPUT_BYTES}}
