"""md_neighbor_list_tpu_torch — the PyTorch/CUDA port of
``md_neighbor_list_tpu``: an MD neighbour-search and short-range LJ force
engine whose hot kernels are hand-written CUDA for NVIDIA Hopper.

Ported so far: the dense LJ engine (build -> lists -> NVE steps) with its
expand, half-list, half-force and pe/virial kernels; the one-call
``neighbor_list`` / ``pair_list`` API over it with the host-side mask decode;
the half-count and full-sweep force and count kernels (parity passes); and the
incremental rebuild (``DenseSimulator(incremental=True)``) with its merge
kernel. The module layout mirrors
the JAX package (``core/``, ``ops/``, ``models/``, ``utils/``), so a module's
counterpart is found by its path; ``ops/dense_force.py`` stands for
``ops/pallas_force.py``. The two packages share no code.
"""

from md_neighbor_list_tpu_torch.api import neighbor_list, pair_list
from md_neighbor_list_tpu_torch.core.config import MDConfig, PRESETS
from md_neighbor_list_tpu_torch.models.dense_lj import DenseSimulator

__version__ = "0.1.0"

__all__ = ["MDConfig", "PRESETS", "DenseSimulator", "neighbor_list",
           "pair_list"]
