"""ms a frame between CUDA events around ``PathTracer.refit_bvh`` (the
upload of the moved triangles, the refit, the collapse plan's gather and the
records), the window's mean."""


def read(run):
    spans = run.spans.get("refit_ms")
    return sum(spans) / len(spans) if spans else None
