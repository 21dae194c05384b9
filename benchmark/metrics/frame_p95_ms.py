"""95th percentile of every frame's time in the window, from its first call
into the program to the return of its synchronise, in ms."""

from common import percentile


def read(run):
    return percentile(run.window.frame_s, 95) * 1e3
