"""Traffic ``progressive``: path-traced samples accumulated into the running
mean. Each frame is ``samples_per_frame`` × ``PathTracer.render_progressive(
bounces)`` and one ``present_progressive()``. With ``camera: "rest"`` the
camera stays at the configuration's view and the mean keeps growing; the seed
sets the ``frame_count`` the window starts from (below ``frame_count_mod``).
With ``camera: "orbit"`` the camera moves ``step_degrees`` a frame on the
circle of the configuration's distance, from an angle drawn from the seed, so
every frame's mean starts anew. Nominal rays: W·H·bounces·2 a sample (each
bounce traces a path ray and a shadow ray).

Check, on each kept frame: (a) the mean at the checked pixels against the
reference's, which adds the reference's samples of those pixels to the mean
the frame started from (the program's state before the frame; zero after a
camera move); a pixel mismatches where a channel's gap, scaled by the
samples in the mean, exceeds ``radiance_gap``. (b) every pixel of the
presented rgba8 against the reference's tonemap of the frame's mean; a pixel
mismatches where a channel differs by more than ``pixel_levels``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

import workcount
from reference import camera as ref_camera
from reference import render as ref_render
from trafficbase import OUTPUT_BYTES, RAY_BYTES, TrafficBase, orbit_camera


class Traffic(TrafficBase):
    def __init__(self, trial) -> None:
        super().__init__(trial)
        cell, cam = trial.cell, trial.cfg["camera"]
        self.bounces = int(cell["bounces"])
        self.spp = int(cell["samples_per_frame"])
        self.rest = cell["camera"] == "rest"
        self.rays_per_frame = self.width * self.height * self.bounces * 2 * self.spp
        if self.rest:
            self.pos, self.quat = tuple(cam["position"]), tuple(cam["quaternion"])
            self.pt.set_camera_position(*self.pos)
            self.pt.set_camera_quaternion(*self.quat)
            self.start_count = int(trial.rng.integers(0, int(cell["frame_count_mod"])))
        else:
            self.radius = float(np.linalg.norm(cam["position"]))
            self.step = math.radians(float(cell["step_degrees"]))
            self.theta0 = float(trial.rng.uniform(0.0, 2.0 * math.pi))
        self.before = {}  # frame → the mean it starts from (rest camera)
        self.last = None

    def camera(self, i: int):
        if self.rest:
            return self.pos, self.quat
        return orbit_camera(self.radius, self.theta0 + i * self.step)

    def frame(self, i: int):
        if not self.rest:
            pos, quat = self.camera(i)
            self.pt.set_camera_position(*pos)
            self.pt.set_camera_quaternion(*quat)
        n = self.pt.frame_count if self.rest else 0
        for _ in range(self.spp):
            acc = self.pt.render_progressive(self.bounces)
        self.last = acc
        return n, acc, self.pt.present_progressive()

    def well_formed(self, handle) -> bool:
        _, acc, img = handle
        return (tuple(acc.shape) == (self.height, self.width, 3) and acc.dtype == torch.float32
                and tuple(img.shape) == (self.height, self.width, 4)
                and img.dtype == torch.uint8)

    def start(self) -> None:
        if self.rest:
            self.pt.set_frame_count(self.start_count)
            self.before[0] = self.last.clone()

    def keep(self, i: int, handle) -> None:
        n, acc, img = handle
        if i in self.trial.check_frames:
            prev = self.before.pop(i) if self.rest else None
            self.kept[i] = (n, prev, acc.clone(), img.clone())
        if self.rest and i + 1 in self.trial.check_frames:
            self.before[i + 1] = acc.clone()

    def _mean(self, tri, i: int, n: int, prev, px: np.ndarray, py: np.ndarray):
        """The mean at pixels (px, py) after frame i's samples, from ``prev``."""
        pos, quat = self.camera(i)
        dt = tri.dtype
        acc = (torch.zeros((px.size, 3), dtype=dt, device=self.device) if prev is None else
               prev[torch.from_numpy(py).to(self.device),
                    torch.from_numpy(px).to(self.device)].to(dt))
        for j in range(self.spp):
            s = ref_render.sample_pixels(tri, pos, quat, self.width, self.height, self.fov,
                                         self.bounces, n + j, px, py, self.device)
            acc = ref_render.accumulate(acc, s, n + j)
        return acc

    def checks(self, ref, ctl=None) -> dict:
        gap = float(self.check["radiance_gap"])
        levels = int(self.check["pixel_levels"])
        bad = total = bad_img = total_img = 0
        for i, (n, prev, acc, img) in sorted(self.kept.items()):
            idx = self.pixels(i)
            px, py = idx % self.width, idx // self.width
            want = self._mean(ref, i, n, prev, px, py)
            if ctl is None:
                got = acc[torch.from_numpy(py).to(self.device),
                          torch.from_numpy(px).to(self.device)]
                shown = img
            else:
                got = self._mean(ctl, i, n, prev, px, py)
                shown = ref_render.present(acc.to(ctl.dtype))
            scaled = (got.double() - want.double()).abs().amax(dim=-1) * (n + self.spp)
            bad += int((scaled > gap).sum())
            total += idx.size
            diff = (shown.int() - ref_render.present(acc).int()).abs().amax(dim=-1)
            bad_img += int((diff > levels).sum())
            total_img += diff.numel()
        return {"frames_checked": len(self.kept), "sample_mismatch": bad / max(total, 1),
                "present_mismatch": bad_img / max(total_img, 1)}

    def frame_work(self, i: int, count: int) -> dict:
        """K1 (the camera wave) and K2 (every later wave) of frame i, counted
        by following ``count`` seeded lanes through their bounces with the
        records' own hits and seeded uniforms."""
        qn, leaf_k = self.records()
        width = workcount.record_width(leaf_k, qn.shape[1])
        dev = self.device
        pos, quat = self.camera(i)
        idx = self.pixels(-1 - i, count=count)
        px, py = idx % self.width, idx // self.width
        jx = torch.from_numpy(ref_camera.subpixel_hash01(px, py, 2 * i)).to(dev)
        jy = torch.from_numpy(ref_camera.subpixel_hash01(px, py, 2 * i + 1)).to(dev)
        d = ref_camera.primary_dirs(torch.from_numpy(px).to(dev), torch.from_numpy(py).to(dev),
                                    self.width, self.height, quat, self.fov, jx, jy)
        o = torch.as_tensor(pos, dtype=torch.float32, device=dev).expand_as(d).contiguous()
        sun = ref_render._unit(ref_render.LIGHT, dev, torch.float32)  # noqa: SLF001
        gen = torch.Generator(device=dev).manual_seed(self.trial.seed + i)
        lanes = self.width * self.height
        scale = lanes / idx.size
        k1 = workcount.Work(width)
        k2_flops = k2_bytes = 0.0

        def wave(o_, d_, any_hit):
            nonlocal k2_flops, k2_bytes
            w = workcount.Work(width)
            out = workcount.traverse(qn, o_.contiguous(), d_.contiguous(), leaf_k, any_hit, w)
            k2_flops += w.flops() * scale
            k2_bytes += w.record_bytes() + w.rays * scale * (RAY_BYTES + OUTPUT_BYTES)
            return out

        t, n, hit = workcount.traverse(qn, o, d, leaf_k, False, k1)
        for b in range(self.bounces):
            if b > 0:
                live = torch.nonzero(hit).squeeze(1)
                o, d = o[live], d[live]
                if live.numel() == 0:
                    break
                t, n, hit = wave(o, d, False)
            n = ref_render._face(n, d)  # noqa: SLF001
            p = o + d * torch.where(hit, t, torch.zeros_like(t))[:, None] + n * ref_render.OFFSET
            nee = hit & ((n * sun).sum(-1) > 0.0)
            if bool(nee.any()):
                wave(p[nee], sun.expand(int(nee.sum()), 3), True)
            u1, u2 = (torch.rand(d.shape[0], generator=gen, device=dev) for _ in range(2))
            d = torch.where(hit[:, None], ref_render._cosine(n, u1, u2), d)  # noqa: SLF001
            o = torch.where(hit[:, None], p, o)
        return {"k1": {"flops": k1.flops() * scale * self.spp,
                       "bytes": (k1.record_bytes() + lanes * OUTPUT_BYTES) * self.spp},
                "k2": {"flops": k2_flops * self.spp, "bytes": k2_bytes * self.spp}}
