"""forces_half_roofline: K3's share of its roofline (%), its bound on the
measured state over its device time a launch (roofline/forces_half.py).
Moves steps_per_s."""

from mdbench.lib import layer


def read(ctx):
    return layer.roofline_share(ctx, "forces_half")
