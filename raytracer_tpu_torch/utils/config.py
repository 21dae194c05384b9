"""RenderConfig — the one-dataclass flag system (SURVEY.md §5.6): a copy of
``raytracer_tpu/utils/config.py``, the same fields and defaults.

The reference hard-codes every tunable (packet size, stack depth, workgroup
sizes, FOV 70°, 1920×1080 canvas, camera speeds, ports). This dataclass
gathers them with the same defaults so behavior is reference-identical out
of the box, while everything is overridable per run.
"""

from __future__ import annotations

from dataclasses import dataclass, field, asdict

__all__ = ["RenderConfig", "CameraConfig", "DEFAULT_CONFIG"]


@dataclass(frozen=True)
class CameraConfig:
    """FPSCamera tunables (input-handler.js:41-48 defaults)."""

    position: tuple[float, float, float] = (0.0, 1.6, 5.0)
    move_speed: float = 4.0
    sprint_mult: float = 2.5
    look_sensitivity: float = 0.002
    fly: bool = True


@dataclass(frozen=True)
class RenderConfig:
    """Scene/render/build tunables with reference-matching defaults."""

    # canvas (index.html:10)
    width: int = 1920
    height: int = 1080
    # camera projection (PathTracer.js:761)
    fov_degrees: float = 70.0
    # traversal (renderer.wgsl:4-8)
    stack_max: int = 64
    # scene ingest (src/main.js:20-23)
    normalize: bool = True
    normalize_mode: str = "cube"
    # BVH
    bvh_arity: int = 4
    widener: str = "collapse"          # "collapse" | "promote"
    # progressive path tracing (our extension)
    spp: int = 1
    bounces: int = 3
    # sidecar ports (api.js:44 / vite.config.js:6)
    api_port: int = 3000
    dev_port: int = 5173
    camera: CameraConfig = field(default_factory=CameraConfig)

    def to_dict(self) -> dict:
        return asdict(self)


DEFAULT_CONFIG = RenderConfig()
