"""The arithmetic that the per-layer metrics share: a kernel's share of its
roofline and the device's idle share. Each metric's file under metrics/ says
which it reads; nothing here knows a metric by name."""

from __future__ import annotations

from mdbench.lib import peaks
from mdbench.lib import spec


def device_ms_per_unit(ctx, outside=()) -> float | None:
    """Device milliseconds a unit (step, build, call) in the traced stretch:
    the union of every device operation over the units traced, leaving out
    the kernels whose names match ``outside``."""
    return ctx.trace.busy_ms_per_unit(outside) if ctx.trace else None


def idle_share(ctx) -> float | None:
    """100 * (1 - traced device ms a unit / untraced wall ms a unit), both
    from the same run: the window first, untraced, then the traced
    stretch. Never over the traced stretch's own wall time."""
    busy = device_ms_per_unit(ctx)
    return None if busy is None else 100.0 * (1.0 - busy
                                              / ctx.wall_ms_per_unit)


def roofline_share(ctx, kernel: str, per_unit: bool = False
                   ) -> float | None:
    """100 * bound / device seconds a launch of ``kernel`` (its file under
    roofline/), where the bound is the larger of its bytes over the HBM
    bandwidth and its flops over the fp32 peak, on the measured inputs; with
    ``per_unit`` the bound of a unit's work over the device seconds of its
    launches a unit (a kernel launched in parts, as the slab sweep's
    interior and boundary). None where the trace holds no launch of it or
    the work is unknown."""
    if ctx.trace is None:
        return None
    mod = spec.roofline(kernel)
    launches, seconds = ctx.trace.kernel(mod.KERNELS)
    work = mod.work(ctx.run.work)
    if not launches or seconds <= 0 or work is None:
        return None
    bound, _ = peaks.bound_s(*work)
    per = ctx.trace.units if per_unit else launches
    return 100.0 * bound / (seconds / per)
