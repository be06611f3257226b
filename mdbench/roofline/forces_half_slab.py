"""K9's K3, the slab form of the half-sweep LJ force kernel as the slab
step runs it (``csrc/force_half.cu``, ``force_sweep_kernel<0, false>``: the
interior launch, ``slab_forces_interior``, and the boundary launch,
``slab_forces_boundary``, two a step): one rank's work a step on the
measured state.

flops = the rank's half pairs within rc x 25, the flops of one LJ pair with
        its reaction (``forces_half.py``)
bytes = (the rank's atoms + its ghost layer's) x 24: each position read
        once (float32 x 3) and each force or seam reaction written once

The pairs are the rank's share as ``reference/slabs.py`` counts it on the
gathered state at the end of the run: those inside its slab and those across
its upper face. Nothing of the cell layout enters.
"""

# template <KIND = kForce (0), ZWRAP = false>, demangled and mangled
KERNELS = [r"force_sweep_kernel<0, ?false>", r"force_sweep_kernelILi0ELb0E"]
FLOPS_PER_PAIR = 25


def work(w: dict):
    if "pairs_rc" not in w or "ghost" not in w:
        return None
    return w["pairs_rc"] * FLOPS_PER_PAIR, (w["n"] + w["ghost"]) * 24
