"""K2's share of its roofline, % (``csrc/traverse_rays.cu``): the least
time of its work a frame over its traced device ms a frame."""

from common import roofline_share


def read(run):
    return roofline_share(run, "k2")
