"""raytracer_tpu_torch — the PyTorch / CUDA port of ``raytracer_tpu``.

Plain tensor code is torch; the traversal kernels are CUDA C++ for Hopper
(``csrc/``: K1a/K1b primary rays, K1c frame batches, K2a/K2b ray buffers),
built with nvcc at first use; ``ops.cuda.traverse.LAUNCHES`` counts each
kernel's launches. Module paths mirror the JAX package so each counterpart
is easy to find. The port imports neither JAX
nor ``raytracer_tpu``: the host modules it needs are carried as copies.

Public surface:
  PathTracer — set_scene / refit_bvh / render / render_presented /
               render_progressive / present_progressive / camera / checkpoints
  Scene      — GLB ingest + normalization
  pt_sample_frame, accumulate — one path-traced sample, the running mean
"""

from .models.scene import Scene
from .pathtracer import PathTracer
from .render_pt import accumulate, pt_sample_frame

__version__ = "0.1.0"

__all__ = ["PathTracer", "Scene", "accumulate", "pt_sample_frame", "__version__"]
