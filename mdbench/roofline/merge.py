"""K8, the incremental rebuild's merge (``csrc/merge.cu``, ``merge_kernel``):
the work the stitch needs on the measured input.

flops = 0 (data movement)
bytes = N x 56 + movers x 4: every particle's record (pos and vel, 24 bytes,
        and its pid, 4) read once from the side it comes from and written
        once into its new slot (28), and for each mover the pid its old slot
        holds on the stayer side (4), which is what tells the stitch that the
        particle left

The movers are those of the reference's binning (``reference/cells.py``) on
the input of the last build of the traced stretch: the particles whose cell
there is not the cell their slot of the input state lies in. Counted from
the particles and not from the slot layout, as ``lists_half.py`` counts its
pairs: the empty slots K8 parks, the slots of a row it loads, and its bit
flags are the layout's cost, not the stitch's, and a roofline that counted
them would read a layout with more slack as nearer its bound.
"""

KERNELS = [r"merge_kernel"]
BYTES_PER_PARTICLE = 56
BYTES_PER_MOVER = 4


def work(w: dict):
    if "movers" not in w:
        return None
    return (0, w["n"] * BYTES_PER_PARTICLE + w["movers"] * BYTES_PER_MOVER)
