"""FPSCamera — headless port of the reference camera controller (host,
NumPy): a copy of ``raytracer_tpu/models/camera.py``, the same float64 math.

Same math and tunables as the reference (src/libs/controls/input-handler.js):
yaw/pitch mouse look with sensitivity 0.002 and pitch clamped to
±(π/2 − 1e−4); orientation quaternion q = yaw(world-Y) ∘ pitch(local-X);
WASD + Q/E movement in fly (camera-space) or ground (yaw-only XZ) frame;
Shift sprint ×2.5. Input arrives through ``press``/``release``/``move_mouse``
calls instead of DOM events — the frame loop calls ``update(dt)`` exactly
like the reference's rAF handler (src/main.js:56-58).
"""

from __future__ import annotations

import math

import numpy as np

__all__ = ["FPSCamera", "CAM_VERSION"]

CAM_VERSION = 4  # input-handler.js:7

_PITCH_CLAMP = math.pi / 2 - 1e-4
_FWD_L = np.array([0.0, 0.0, -1.0])
_RIGHT_L = np.array([1.0, 0.0, 0.0])
_UP_L = np.array([0.0, 1.0, 0.0])


def _quat_axis_angle(axis, angle):
    s = math.sin(angle / 2)
    return np.array([axis[0] * s, axis[1] * s, axis[2] * s, math.cos(angle / 2)])


def _quat_mul(a, b):
    ax, ay, az, aw = a
    bx, by, bz, bw = b
    return np.array(
        [
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
            aw * bw - ax * bx - ay * by - az * bz,
        ]
    )


def _quat_rotate(q, v):
    u, s = q[:3], q[3]
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return v + 2.0 * (s * uv + uuv)


class FPSCamera:
    """WASD/mouse camera with fly and ground-walk movement frames."""

    def __init__(
        self,
        position=(0.0, 1.6, 5.0),
        move_speed: float = 4.0,
        sprint_mult: float = 2.5,
        look_sensitivity: float = 0.002,
        fly: bool = True,
    ) -> None:
        self._pos = np.array(position, dtype=np.float64)
        self._yaw = 0.0
        self._pitch = 0.0
        self._q = np.array([0.0, 0.0, 0.0, 1.0])
        self._base = move_speed
        self._sprint = sprint_mult
        self._sens = look_sensitivity
        self._fly = fly
        self._keys: set[str] = set()

    # -- input surface ---------------------------------------------------------

    def press(self, code: str) -> None:
        """Key down; codes use the DOM names: KeyW/KeyA/KeyS/KeyD/KeyQ/KeyE,
        ShiftLeft/ShiftRight."""
        self._keys.add(code)

    def release(self, code: str) -> None:
        self._keys.discard(code)

    def clear_keys(self) -> None:
        self._keys.clear()

    def move_mouse(self, dx: float, dy: float) -> None:
        """Pointer-lock mouse delta (input-handler.js:64-69)."""
        self._yaw -= dx * self._sens
        self._pitch -= dy * self._sens
        self._pitch = min(max(self._pitch, -_PITCH_CLAMP), _PITCH_CLAMP)

    def set_fly(self, enabled: bool) -> None:
        self._fly = bool(enabled)

    @property
    def fly(self) -> bool:
        return self._fly

    # -- per-frame update --------------------------------------------------------

    def update(self, dt: float) -> None:
        q_yaw = _quat_axis_angle([0, 1, 0], self._yaw)
        q_pitch = _quat_axis_angle([1, 0, 0], self._pitch)
        q = _quat_mul(q_yaw, q_pitch)
        self._q = q / np.linalg.norm(q)

        fwd = _quat_rotate(self._q, _FWD_L)
        right = _quat_rotate(self._q, _RIGHT_L)
        up = _quat_rotate(self._q, _UP_L)

        if not self._fly:  # ground walker: project to XZ (input-handler.js:113-123)
            fwd[1] = 0.0
            right[1] = 0.0
            lf = np.linalg.norm(fwd)
            lr = np.linalg.norm(right)
            if lf > 1e-6:
                fwd /= lf
            if lr > 1e-6:
                right /= lr
            up = np.array([0.0, 1.0, 0.0])

        move = np.zeros(3)
        if "KeyW" in self._keys:
            move += fwd
        if "KeyS" in self._keys:
            move -= fwd
        if "KeyD" in self._keys:
            move += right
        if "KeyA" in self._keys:
            move -= right
        if "KeyE" in self._keys:
            move += up
        if "KeyQ" in self._keys:
            move -= up

        ln = np.linalg.norm(move)
        if ln > 1e-6:
            move /= ln
            sprint = "ShiftLeft" in self._keys or "ShiftRight" in self._keys
            speed = self._base * self._sprint if sprint else self._base
            self._pos += move * (speed * dt)

    # -- UBO accessors -------------------------------------------------------------

    @property
    def position(self) -> np.ndarray:
        return self._pos

    @property
    def rotation(self) -> np.ndarray:
        """Orientation quaternion [x, y, z, w]."""
        return self._q

    def to_array(self):
        return [*self._pos, 0.0, *self._q]
