"""The device's idle share, %: 1 − (profiler busy ms a frame of the traced
stretch ÷ ms a frame of the untraced window of the same process). The
profiler's own wall is inflated by its host cost, so it is not used."""

from devtrace import busy_us


def read(run):
    if run.trace is None or not run.trace.device or not run.window.frames:
        return None
    busy_ms = busy_us(run.trace.device) / 1e3 / run.trace.frames
    frame_ms = run.window.seconds / run.window.frames * 1e3
    return 100.0 * (1.0 - busy_ms / frame_ms)
