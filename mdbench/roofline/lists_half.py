"""K2, the half-sweep list kernel (``csrc/lists_half.cu``, the cube form
that writes masks): the work the physics needs on the measured input.

flops = half pairs within rs x 8, the flops of one distance test: 3
        differences, 3 multiplies, 2 adds
bytes = N x 12 (positions read once) + 4 a half pair and 4 a particle
        written: the smallest index list that holds the pairs (one int32
        partner a pair, one int32 count or offset a particle)

The pairs are counted by the reference on the input of the last build of
the traced stretch. Nothing of the cell layout (slots, mask words, candidates
tested) enters.
"""

# template <ZWRAP = true, MASKS = true>, demangled and mangled
KERNELS = [r"lists_half_kernel<true, ?true>", r"lists_half_kernelILb1ELb1E"]
FLOPS_PER_PAIR = 8


def work(w: dict):
    if "pairs_rs" not in w:
        return None
    return (w["pairs_rs"] * FLOPS_PER_PAIR,
            w["n"] * 12 + 4 * w["pairs_rs"] + 4 * w["n"])
