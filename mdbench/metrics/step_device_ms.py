"""step_device_ms: device milliseconds an NVE step (the union of every
device operation in the traced stretch over its steps): the step loop and
chunk runner's layer. Moves steps_per_s."""

from mdbench.lib import layer


def read(ctx):
    return layer.device_ms_per_unit(ctx)
