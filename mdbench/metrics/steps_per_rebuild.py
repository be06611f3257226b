"""steps_per_rebuild: NVE steps a rebuild. Where the driver keeps the run's
own counters (``run.counters``, read from the program's state: the slab
engine's ``n_rebuilds``), over the steps it counted there: the window and
the traced stretch. Else from the program's own counters
(``md_neighbor_list_tpu_torch.utils.trace.COUNTS``: ``steps`` over
``rebuilds``) as they stand when the metrics are read: the whole run of this
process (set-up's steps, the window, the traced stretch and the check's
steps). Moves steps_per_s. None where neither has counters or counted no
rebuild."""


def read(ctx):
    counters = getattr(ctx.run, "counters", None)
    if counters is not None:
        return (counters["steps"] / counters["rebuilds"]
                if counters["rebuilds"] else None)
    try:
        from md_neighbor_list_tpu_torch.utils.trace import COUNTS
    except ImportError:  # a program without the counters
        return None
    if not COUNTS["rebuilds"]:
        return None
    return COUNTS["steps"] / COUNTS["rebuilds"]
