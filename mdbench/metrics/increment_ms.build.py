"""increment_ms.build: device milliseconds of the incremental rebuild's own
pass a list build (the wrap, the keys, the mover sort and expand, the window
predicate and K8), read as increment_ms.steps reads it a rebuild: the union
of the device operations between each pair of the program's ``increment``
marker kernels. Moves build_ms. None where the trace holds no pair (a
program without the markers, or a build that makes no incremental pass)."""

from mdbench.lib import spec

read = spec.metric_reader("increment_ms.steps").read
