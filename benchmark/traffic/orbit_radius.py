"""Traffic ``orbit_radius``: the traffic ``orbit`` (``PathTracer.render()``
from a camera on a circle about the scene's centre, ``step_degrees`` a frame
from an angle drawn from the seed, checked pixel by pixel against the
reference's shading) at the radius the cell file gives in ``radius``, in
place of the distance of the configuration's camera."""

from __future__ import annotations

from common import HERE, load_module

_orbit = load_module(HERE / "traffic" / "orbit.py", "traffic_orbit")


class Traffic(_orbit.Traffic):
    def __init__(self, trial) -> None:
        super().__init__(trial)
        self.radius = float(trial.cell["radius"])
