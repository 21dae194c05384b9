"""Device ms a frame of every operation that is not K1 or K2: the path
tracer's glue (``render_pt.py``, ``ops/shade.py``, ``ops/partition.py``),
accumulate and present."""

from devtrace import layer_ms_per_frame


def read(run):
    return None if run.trace is None else layer_ms_per_frame(run.trace, "glue")
