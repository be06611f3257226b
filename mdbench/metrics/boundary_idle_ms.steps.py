"""boundary_idle_ms.steps: device-idle milliseconds a traced chunk at the
chunk's boundary: the gaps whose middle falls in the program's span
``chunk.snapshot``, ``chunk.settle`` or ``chunk.redo``, or in ``chunk``
outside its children (``lib/spans.py``). Moves steps_per_s. None where the
trace holds no program span."""

from mdbench.lib import spans

NAMES = ("chunk", "chunk.snapshot", "chunk.settle", "chunk.redo")


def read(ctx):
    return spans.idle_ms_per_chunk(ctx, NAMES)
