"""nccl_ms_per_step: device milliseconds a step of the NCCL kernels (the
ring's shifts and reductions, captured in the step) in the traced stretch,
the largest rank's. An NCCL kernel runs from its start until its peers' data
has come, so the number holds the wait for the slowest rank as well as the
transfer. Moves steps_per_s. None where the trace holds no NCCL kernel."""

PATTERNS = [r"(?i)nccl"]


def read(ctx):
    tr = ctx.trace
    if tr is None or not tr.units:
        return None
    launches, seconds = tr.kernel(PATTERNS)
    return seconds * 1e3 / tr.units if launches else None
