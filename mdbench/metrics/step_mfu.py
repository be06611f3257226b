"""step_mfu: the whole NVE step's share of the chip's fp32 peak (%): the
flops a step needs on the measured state over the untraced wall time a step
times 67 TFLOP/s. A step needs the pair forces (roofline/forces_half.py: 25
a pair within rc) and the integrator, 26 a particle (two half kicks, 6
each; the drift, 6; the displacement vote, 8). It bounds every kernel's
gain on the step. Moves steps_per_s."""

from mdbench.lib import peaks, spec

FLOPS_PER_PARTICLE = 26


def read(ctx):
    w = ctx.run.work
    if "pairs_rc" not in w:
        return None
    flops = (w["pairs_rc"] * spec.roofline("forces_half").FLOPS_PER_PAIR
             + w["n"] * FLOPS_PER_PARTICLE)
    return 100.0 * flops / (ctx.wall_ms_per_unit * 1e-3
                            * peaks.FP32_FLOPS_PER_S)
