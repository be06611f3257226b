"""lists_half_roofline: K2's share of its roofline (%), its bound on the
measured input over its device time a launch (roofline/lists_half.py).
Moves build_ms."""

from mdbench.lib import layer


def read(ctx):
    return layer.roofline_share(ctx, "lists_half")
