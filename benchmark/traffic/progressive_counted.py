"""Traffic ``progressive_counted``: the traffic ``progressive`` (path-traced
samples accumulated into the running mean, checked against the reference),
which after the traced stretch of a ``--trace 1`` run also counts: a stretch
of as many frames, after the traced ones, with the program's counters on and
its spans off (``spans.host_stretch``), whose totals of K2's lanes
(``rt/k2/lanes``, ``rt/k2/active``) and of the NEE shadow rays
(``rt/pt/shadow/cast``, ``rt/pt/shadow/blocked``) it records as spans of the
trial under those names. A counter the program does not keep is left out.
The window and the traced stretch run as in ``progressive``."""

from __future__ import annotations

import spans
from common import HERE, load_module

_progressive = load_module(HERE / "traffic" / "progressive.py", "traffic_progressive")

COUNTERS = ("rt/k2/lanes", "rt/k2/active", "rt/pt/shadow/cast", "rt/pt/shadow/blocked")


class Traffic(_progressive.Traffic):
    def collect(self) -> None:
        trial = self.trial
        trial.next_frame = trial.traced.stop
        counted = spans.host_stretch(trial, max(len(trial.traced), 1), spans=False,
                                     counters=True)["counters"]
        for name in COUNTERS:
            if name in counted:
                trial.span(name, counted[name])
