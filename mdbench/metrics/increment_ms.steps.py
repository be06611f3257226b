"""increment_ms.steps: device milliseconds of the incremental rebuild's own
pass a rebuild taken inside an NVE step (the wrap, the keys, the mover sort
and expand, the window predicate and K8): the union of the device operations
between each pair of the program's ``increment`` marker kernels
(``lib/spans.py``), over the pairs in the traced stretch. Moves steps_per_s.
None where the trace holds no pair (a program without the markers, or a
stretch with no rebuild)."""

from mdbench.lib import spans


def read(ctx):
    if ctx.trace is None:
        return None
    found = spans.device_spans(ctx.trace, "increment")
    if not found:
        return None
    return sum(busy for _, _, busy in found) * 1e3 / len(found)
