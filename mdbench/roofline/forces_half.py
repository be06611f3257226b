"""K3, the half-sweep LJ force kernel (``csrc/force_half.cu``, the cube
form without PE): the work the physics needs on the measured state.

flops = half pairs within rc x 25, the flops of one LJ pair with its
        reaction: 3 differences, r^2 (3 multiplies, 2 adds), 1/r^2 (1),
        s6 (2 multiplies), 24 s6 (2 s6 - 1) s2 (5), the pair force along
        d (3 multiplies), added to the own sum and taken from the
        partner's (6)
bytes = N x 12 (positions, float32 x 3, read once)
        + N x 12 (forces, written once)

The pairs are counted by the reference on the state at the end of the
traced stretch. Nothing of the cell layout (slots, candidates tested)
enters.
"""

# the cube form without PE: template <KIND = kForce (0), ZWRAP = true>,
# demangled and mangled
KERNELS = [r"force_half_kernel<0, ?true>", r"force_half_kernelILi0ELb1E"]
FLOPS_PER_PAIR = 25


def work(w: dict):
    if "pairs_rc" not in w:
        return None
    return w["pairs_rc"] * FLOPS_PER_PAIR, w["n"] * 24
