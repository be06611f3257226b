"""launch_idle_ms.steps: device-idle milliseconds a traced chunk while the
host launches it: the gaps whose middle falls in the program's span
``chunk.launch`` (the capture key, the replays) or ``graph.capture``
(``lib/spans.py``). Moves steps_per_s. None where the trace holds no program
span."""

from mdbench.lib import spans

NAMES = ("chunk.launch", "graph.capture")


def read(ctx):
    return spans.idle_ms_per_chunk(ctx, NAMES)
