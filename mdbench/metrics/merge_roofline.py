"""merge_roofline: K8's share of its roofline (%), its bound on the measured
input over its device time a launch (roofline/merge.py). Moves build_ms."""

from mdbench.lib import layer


def read(ctx):
    return layer.roofline_share(ctx, "merge")
