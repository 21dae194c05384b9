"""Seconds from the process's start to the first timed frame: imports, the
scene, the build, the warm-up (and, in a checkout's first run, the build of
the CUDA libraries)."""


def read(run):
    return run.setup_s
