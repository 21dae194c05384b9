"""Seconds of ``PathTracer.build_bvh`` in set-up (the native SAH build of
the clusters, the device collapse and the records), ending in a
synchronise."""


def read(run):
    return run.build_s
