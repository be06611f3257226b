"""steps_per_rebuild: NVE steps a rebuild, from the program's own counters
(``md_neighbor_list_tpu_torch.utils.trace.COUNTS``: ``steps`` over
``rebuilds``) as they stand when the metrics are read: the whole run of this
process (set-up's steps, the window, the traced stretch and the check's
steps). Moves steps_per_s. None where the program has no such counters or
counted no rebuild."""


def read(ctx):
    try:
        from md_neighbor_list_tpu_torch.utils.trace import COUNTS
    except ImportError:  # a program without the counters
        return None
    if not COUNTS["rebuilds"]:
        return None
    return COUNTS["steps"] / COUNTS["rebuilds"]
