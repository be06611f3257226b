"""forces_half_slab_roofline: the slab sweep's share of its roofline (%) a
step, on the rank whose sweep takes longest: the bound of the rank's work a
step (roofline/forces_half_slab.py) over the device time of its interior
and boundary launches a traced step. Moves steps_per_s."""

from mdbench.lib import layer, spec


def read(ctx):
    share = layer.roofline_share(ctx, "forces_half_slab", per_unit=True)
    if share is None:
        return None
    _, seconds = ctx.trace.kernel(spec.roofline("forces_half_slab").KERNELS)
    return [share, seconds / ctx.trace.units]


def combine(readings):
    """The share of the rank with the most sweep time a step."""
    return max(readings, key=lambda r: r[1])[0]
