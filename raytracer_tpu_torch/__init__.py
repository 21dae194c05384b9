"""raytracer_tpu_torch — the PyTorch / CUDA port of ``raytracer_tpu``.

Plain tensor code is torch; the traversal kernels are CUDA C++ for Hopper
(``csrc/``: K1a/K1b primary rays, K1c frame batches, K1d per-tile depth bounds
and entry nodes, K1e/K2c 8-wide records, K1f visit counts, K2a/K2b ray buffers),
built with nvcc at first use; ``ops.cuda.traverse.LAUNCHES`` counts each
kernel's launches. Module paths mirror the JAX package so each counterpart
is easy to find; the headless apps are ``python -m
raytracer_tpu_torch.apps.main`` and ``apps.debug``. The port imports neither JAX
nor ``raytracer_tpu``: the host modules it needs are carried as copies.

Public surface:
  PathTracer — from_config / set_scene / refit_bvh / render /
               render_presented / render_stream / render_progressive /
               present_progressive / use_tile_entries / camera / artifacts /
               checkpoints; on the card unless ``device="cpu"``
  fast_build_options — the fastest (builder, leaf_size) on a device
  Scene      — GLB ingest + normalization
  FPSCamera  — WASD/mouse camera controller
  pt_sample_frame, accumulate — one path-traced sample, the running mean
  render_ldr, render_ldr_brute, render_frame_u8 — one shaded primary-ray frame
  trace_tiles_bounded, trace_tiles_temporal — the exact primary-ray trace
               under per-tile depth bounds (coarse probe / previous sample)
  compute_tile_entries — per-tile entry nodes
"""

from .models.camera import FPSCamera
from .models.scene import Scene
from .ops.cuda.entry import compute_tile_entries
from .pathtracer import PathTracer, fast_build_options
from .render import (render_frame_u8, render_ldr, render_ldr_brute, trace_tiles_bounded,
                     trace_tiles_temporal)
from .render_pt import accumulate, pt_sample_frame

__version__ = "0.1.0"

__all__ = ["PathTracer", "Scene", "FPSCamera", "fast_build_options", "accumulate", "pt_sample_frame", "render_ldr",
           "render_ldr_brute", "render_frame_u8", "trace_tiles_bounded",
           "trace_tiles_temporal", "compute_tile_entries", "__version__"]
