"""What every traffic kind shares: the trial it serves, the orbit camera,
the pixels a check draws, and no-op hooks.

A traffic kind (``traffic/<kind>.py``) defines ``Traffic(trial)`` with
``rays_per_frame`` (the nominal rays of a frame, by the formula of the
project's suite), ``prepare(i)`` (make frame i's input, outside the frame's
clock; a no-op unless the traffic makes input a frame), ``frame(i)`` (issue
frame i: its calls into the program, returning a handle), ``wait(handle)`` (the frame's one synchronise),
``well_formed``, ``keep(i, handle)`` (keep what the check needs of the frames
in ``trial.check_frames``), ``checks(ref, ctl)`` (the numbers compared; with
``ctl``, the control's outputs in the program's place) and
``frame_work(i, rays)`` (the traversal kernels' operations and bytes in frame
i, counted on ``rays`` seeded rays).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from common import sync

__all__ = ["TrafficBase", "orbit_camera", "OUTPUT_BYTES", "RAY_BYTES"]

OUTPUT_BYTES = 20  # t, normal, triangle: five 4-byte words a ray
RAY_BYTES = 24     # origin and direction, f32
_WORK_FRAMES = 4   # traced frames the work is counted on


def orbit_camera(radius: float, theta: float) -> tuple[tuple, tuple]:
    """A camera on the circle of ``radius`` about the origin in the y = 0
    plane at angle ``theta`` from +z, looking at the origin."""
    pos = (radius * math.sin(theta), 0.0, radius * math.cos(theta))
    quat = (0.0, math.sin(0.5 * theta), 0.0, math.cos(0.5 * theta))
    return pos, quat


class TrafficBase:
    def __init__(self, trial) -> None:
        self.trial = trial
        self.pt = trial.pt
        self.device = trial.device
        cfg = trial.cfg
        self.width, self.height = int(cfg["width"]), int(cfg["height"])
        self.fov = float(cfg["fov_degrees"])
        self.check = trial.cell["check"]
        self.kept: dict = {}

    def prepare(self, i: int) -> None:
        """Make frame i's input before the frame's clock starts."""

    def wait(self, handle) -> None:
        sync(self.device)

    def well_formed(self, handle) -> bool:
        return True

    def start(self) -> None:
        """Called once after the warm-up, before the window."""

    def collect(self) -> None:
        """Called after the traced stretch: turn recorded events into spans."""

    def release(self) -> None:
        self.pt = None

    def pixels(self, frame: int, population: int | None = None, count: int | None = None
               ) -> np.ndarray:
        """``count`` (default ``check.pixels``) distinct indices below
        ``population`` (default W·H), drawn from the seed and ``frame``."""
        population = population or self.width * self.height
        rng = np.random.default_rng([self.trial.seed % 2**64, frame % 2**32])
        return np.sort(rng.choice(population, size=min(count or int(self.check["pixels"]),
                                                       population), replace=False))

    def work(self) -> dict:
        """Operations and bytes a frame of each traversal layer: the mean over
        up to 4 frames spread over the traced stretch, ``check.pixels`` rays
        shared among them."""
        frames = list(self.trial.traced)
        picks = frames[::max(1, len(frames) // _WORK_FRAMES)][:_WORK_FRAMES]
        rays = max(1, int(self.check["pixels"]) // len(picks))
        per = [self.frame_work(i, rays) for i in picks]
        return {layer: {k: float(np.mean([p[layer][k] for p in per])) for k in ("flops", "bytes")}
                for layer in per[0]}

    def records(self) -> tuple[torch.Tensor, int]:
        """The program's current records and their triangles a leaf, which
        the work count walks."""
        return self.pt._qnodes, int(self.pt.leaf_size)
