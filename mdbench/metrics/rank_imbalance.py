"""rank_imbalance: 100 x (the largest rank's device milliseconds a step
outside the NCCL kernels / the ranks' mean - 1), each rank's from its own
traced stretch (the union of its device operations over the traced steps,
lib/layer.py, leaving out the kernels that nccl_ms_per_step reads). An NCCL
kernel runs until its peers' data has come, so a rank that finishes early
fills the wait with it: with those kernels in, every rank would read the
slowest's time. Every rank waits for the slowest at each exchange. Moves
steps_per_s."""

from mdbench.lib import layer, spec


def read(ctx):
    nccl = spec.metric_reader("nccl_ms_per_step").PATTERNS
    return layer.device_ms_per_unit(ctx, outside=nccl)


def combine(readings):
    return 100.0 * (max(readings) * len(readings) / sum(readings) - 1.0)
