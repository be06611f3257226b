"""halflist_ms.steps: device milliseconds of the step's half list a rebuild
taken inside an NVE step (K2, the list's count, its starts and its pack): the
union of the device operations between each pair of the program's
``halflist`` marker kernels (``lib/spans.py``), over the pairs in the traced
stretch. Moves steps_per_s. None where the trace holds no pair (a program
without the markers, or a stretch with no rebuild)."""

from mdbench.lib import spans


def read(ctx):
    if ctx.trace is None:
        return None
    found = spans.device_spans(ctx.trace, "halflist")
    if not found:
        return None
    return sum(busy for _, _, busy in found) * 1e3 / len(found)
