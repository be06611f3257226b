"""device_idle.build: the device's idle share (%) of a list build,
100 x (1 - traced device ms a unit / untraced wall ms a unit), both from the
same --trace 1 run (lib/layer.py). Moves the cell's end-to-end metric."""

from mdbench.lib import layer


def read(ctx):
    return layer.idle_share(ctx)
