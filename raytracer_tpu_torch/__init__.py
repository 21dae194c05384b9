"""raytracer_tpu_torch — the PyTorch / CUDA port of ``raytracer_tpu``.

Plain tensor code is torch; the traversal kernel is CUDA C++ for Hopper
(``csrc/``), built with nvcc at first use. Module paths mirror the JAX
package so each counterpart is easy to find. The port imports neither JAX
nor ``raytracer_tpu``: the host modules it needs are carried as copies.

Public surface:
  PathTracer — set_scene / render / render_presented / camera / checkpoints
  Scene      — GLB ingest + normalization
"""

from .models.scene import Scene
from .pathtracer import PathTracer

__version__ = "0.1.0"

__all__ = ["PathTracer", "Scene", "__version__"]
