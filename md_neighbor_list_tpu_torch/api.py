"""One-call neighbour-list API — the library's front door (PyTorch port of
``md_neighbor_list_tpu/api.py``).

"Given positions + box + search radius, emit a per-particle neighbour list /
pair list":

    import md_neighbor_list_tpu_torch as mdnl
    idx, cnt = mdnl.neighbor_list(pos, L, 2.8)         # (N, K) + (N,)
    i, j = mdnl.pair_list(pos, L, 2.8)                 # explicit pairs

Contract: rows and entries are in the CALLER's particle order, padded with the
sentinel ``N``; capacities are grown on detected overflow, never silently
truncated. The build runs on ``device`` — the card unless the caller passes
``device="cpu"`` — through the dense engine: rebuild (expand kernel), one-pass
half-list kernel, and the host-side mask decode. For an MD loop use
``DenseSimulator`` instead; this entry point is for one-shot builds.

Not ported yet: the XLA-style sweep backend of the JAX package
(``backend="xla"`` with its ``layout=`` and ``chunk=`` options). A box too
small for the cell grid (fewer than 3 cells per side) takes the O(N^2) oracle.
"""

from __future__ import annotations

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.capacity import estimate_neighbors
from md_neighbor_list_tpu_torch.ops import oracle
from md_neighbor_list_tpu_torch.ops.decode import masks_to_padded
from md_neighbor_list_tpu_torch.ops.dense_cells import (from_packed, grow_cap,
                                                        make_spec,
                                                        rebuild_dense)
from md_neighbor_list_tpu_torch.ops.dense_force import dense_lists_half


def _as_box(box) -> Box:
    return box if isinstance(box, Box) else Box(L=float(box))


def _dense_neighbor_list(pos: torch.Tensor, box: Box, radius: float,
                         half: bool, k_cap: int | None):
    """The dense-engine path: rebuild + one-pass half-list kernel on
    ``pos``'s device, then the host-side mask decode. Returns numpy
    (idx, cnt). A cell holding more than ``cap`` particles is detected by
    slot-count conservation and recovered by cap growth, never truncated."""
    n = pos.shape[0]
    pid = torch.arange(n, dtype=torch.int32, device=pos.device)
    vel = torch.zeros_like(pos)
    cap = 40  # default occupancy envelope; grown on overflow
    while True:
        spec = make_spec(box, radius, cap)  # raises if mc < 3 (caller gates)
        if n <= spec.slots:
            state, _ = rebuild_dense(from_packed(pos, vel, pid, spec), spec)
            if int(state.valid().sum()) == n:
                break
        cap = grow_cap(cap)  # too few slots, or a cell run overflowed its own
    _, masks = dense_lists_half(state.pos, spec, radius)
    return masks_to_padded(masks, state.pid, spec, n=n, k_cap=k_cap,
                           full=not half)


def _oracle_neighbor_list(pos: torch.Tensor, box: Box, radius: float,
                          half: bool, k_cap: int | None):
    """All-pairs rows for a box without a usable cell grid; numpy (idx, cnt).
    The row capacity starts at the density estimate and grows on overflow
    unless the caller fixed it."""
    n = pos.shape[0]
    k = k_cap if k_cap is not None else estimate_neighbors(
        n / box.volume(), radius, half_list=half)
    while True:
        idx, cnt = oracle.neighbors(pos, box, radius, k, half)
        most = int(cnt.max())
        if most <= k:
            return idx.cpu().numpy(), cnt.cpu().numpy()
        if k_cap is not None:
            raise ValueError(
                f"k_cap={k_cap} overflows: max neighbor count is {most}; "
                "pass a larger k_cap or let it default")
        k = int(k * 1.5) + 8


def _neighbor_rows(pos, box, radius: float, half: bool, k_cap: int | None,
                   backend: str, device):
    """numpy (idx, cnt) of ``neighbor_list``, before they go to ``device``."""
    if backend not in ("auto", "xla", "dense"):
        raise ValueError(f"backend={backend!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "neighbor_list runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    if backend == "xla":
        raise NotImplementedError(
            "backend='xla' (the sweep engine of ops/binning.py and "
            "ops/pairlist.py) is not ported yet: ROADMAP.md, queue A.10")
    box = _as_box(box)
    pos = box.wrap(torch.as_tensor(pos, dtype=torch.float32).to(device))
    n = pos.shape[0]
    if n == 0:
        k = k_cap if k_cap is not None else 8
        return np.zeros((0, k), np.int32), np.zeros((0,), np.int32)
    if backend == "dense" or int(box.L / radius) >= 3:
        return _dense_neighbor_list(pos, box, radius, half, k_cap)
    return _oracle_neighbor_list(pos, box, radius, half, k_cap)


def neighbor_list(pos, box, radius: float, *, half: bool = False,
                  k_cap: int | None = None, backend: str = "auto",
                  device="cuda"):
    """Fixed-capacity padded neighbour lists for arbitrary positions.

    Args:
      pos:    (N, 3) positions, a tensor on any device or an array; taken as
              float32 on ``device`` and wrapped into [0, L) internally.
      box:    periodic cube side length L, or a ``Box``.
      radius: search radius (e.g. rc + skin).
      half:   True → Newton-3 half lists: each unordered pair appears in
              exactly ONE row (attribution follows the engine's cell order,
              not index order — canonicalize with ``pair_list`` if you need
              i < j). False → full symmetric rows.
      k_cap:  fixed row capacity K. Default: the largest count, rounded up to
              a multiple of 8. If given explicitly, an overflow raises
              ``ValueError`` (the caller asked for a hard shape contract).
      backend: "auto" (default) or "dense": the dense engine + host-side
              mask decode; "auto" takes the O(N^2) oracle instead when the
              box holds fewer than 3 cells per side, where "dense" raises.
              "xla" is not ported yet and raises ``NotImplementedError``.
      device: where the build runs: the card by default (raises without
              one); ``"cpu"`` runs the kernels' plain versions.

    Returns (idx, cnt) on ``device``: ``idx`` (N, K) int32, row i = neighbour
    indices of particle i in the caller's order, padded with the sentinel N;
    ``cnt`` (N,) int32 true neighbour counts.
    """
    idx, cnt = _neighbor_rows(pos, box, radius, half, k_cap, backend, device)
    return (torch.from_numpy(idx).to(device), torch.from_numpy(cnt).to(device))


def pair_list(pos, box, radius: float, *, k_cap: int | None = None,
              backend: str = "auto", device="cuda"):
    """Explicit half pair list (i, j) with i < j, each unordered pair once:
    numpy int32 arrays, the host-side expansion of
    ``neighbor_list(..., half=True)`` with the same arguments. Total length
    == the exact pair count."""
    idx, _ = _neighbor_rows(pos, box, radius, True, k_cap, backend, device)
    n = idx.shape[0]
    keep = idx < n
    i = np.nonzero(keep)[0]  # row of every kept entry, row-major
    j = idx[keep].astype(np.int64)
    return (np.minimum(i, j).astype(np.int32),
            np.maximum(i, j).astype(np.int32))


__all__ = ["neighbor_list", "pair_list"]
