"""rebuild_ms.build: device milliseconds a list build outside K2 and the
harness's own work (its drift and the copy of the pair total, marked
``mdbench.harness``): the rebuild's keys, sort and K1, and the copies into
the build's buffers. Moves build_ms. None where the trace shows no K2 or
cannot place the harness's work."""

from mdbench.lib import spec


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    launches, k2 = tr.kernel(spec.roofline("lists_half").KERNELS)
    harness = tr.marked_s("harness")
    if not launches or harness is None:
        return None
    return (tr.busy_s - k2 - harness) * 1e3 / tr.units
