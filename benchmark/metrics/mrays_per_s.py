"""Nominal rays of all frames completed in the window ÷ the window's seconds, in millions."""


def read(run):
    return run.window.frames * run.rays_per_frame / run.window.seconds / 1e6
