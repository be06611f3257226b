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
half-list kernel, and the host-side mask decode (``backend="dense"``); or
through the bin + 27-cell sweep of ``ops/pairlist.py`` (``backend="xla"``, the
JAX package's name; plain PyTorch), which takes the O(N^2) oracle on a box too
small for the cell grid. ``backend="auto"`` routes by the JAX package's rule
(``use_dense``). For an MD loop use ``DenseSimulator`` or ``Simulator``
instead; this entry point is for one-shot builds.
"""

from __future__ import annotations

import numpy as np
import torch

from md_neighbor_list_tpu_torch.core.box import Box
from md_neighbor_list_tpu_torch.core.capacity import estimate
from md_neighbor_list_tpu_torch.ops import oracle
from md_neighbor_list_tpu_torch.ops.binning import make_grid
from md_neighbor_list_tpu_torch.ops.decode import masks_to_padded
from md_neighbor_list_tpu_torch.ops.dense_cells import (from_packed, grow_cap,
                                                        make_spec,
                                                        rebuild_dense)
from md_neighbor_list_tpu_torch.ops.dense_force import dense_lists_half
from md_neighbor_list_tpu_torch.ops.pairlist import \
    build_neighbor_lists_stable


def _as_box(box) -> Box:
    return box if isinstance(box, Box) else Box(L=float(box))


def _dense_neighbor_list(pos: torch.Tensor, box: Box, radius: float,
                         half: bool, k_cap: int | None):
    """The dense-engine path: rebuild + one-pass half-list kernel on
    ``pos``'s device, then the host-side mask decode. Returns (idx, cnt) on
    the host. A cell holding more than ``cap`` particles is detected by
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
    idx, cnt = masks_to_padded(masks, state.pid, spec, n=n, k_cap=k_cap,
                               full=not half)
    return torch.from_numpy(idx), torch.from_numpy(cnt)


# The auto rule's crossover, the JAX package's: below this N the sweep's
# one-shot build avoids the dense path's host-side decode.
DENSE_API_MIN_N = 500_000


def use_dense(backend: str, device, n: int, L: float, radius: float) -> bool:
    """The routing rule of ``neighbor_list``: "dense" always; "auto" only off
    the CPU, at N >= DENSE_API_MIN_N, and where the box holds at least 3
    cells of ``radius`` a side."""
    return backend == "dense" or (
        backend == "auto" and torch.device(device).type != "cpu"
        and n >= DENSE_API_MIN_N and int(L / radius) >= 3)


def _sweep_neighbor_list(pos: torch.Tensor, box: Box, radius: float,
                         half: bool, k_cap: int | None, layout: str,
                         chunk: int):
    """The sweep path (the JAX ``backend="xla"``): bin + 27-cell sweep in the
    caller's order, or the all-pairs oracle where the box holds fewer than 3
    cells a side. K and the cell capacity start at the density estimate; a
    cell-table overflow grows the table and runs again, even under an
    explicit ``k_cap`` (a dropping table undercounts); a row overflow grows
    K, or raises under an explicit ``k_cap``."""
    n = pos.shape[0]
    grid = make_grid(box, radius)
    est = estimate(n / box.volume(), radius, grid.cell_size, half_list=half)
    k = k_cap if k_cap is not None else max(est.neighbors, 8)
    cell_cap = max(est.cell, 8)
    while True:
        if not grid.usable:
            idx, cnt = oracle.neighbors(pos, box, radius, k, half)
            most = int(cnt.max())
            cell_of = False
        else:
            nl = build_neighbor_lists_stable(pos, box, grid, radius, k,
                                             cell_cap, half, layout=layout,
                                             chunk=chunk)
            idx, cnt = nl.idx, nl.count
            most = int(nl.max_count)
            cell_of = int(nl.cell_max) > cell_cap
        if cell_of:
            cell_cap = int(cell_cap * 1.5) + 8
            continue
        if most <= k:
            return idx, cnt
        if k_cap is not None:
            raise ValueError(
                f"k_cap={k_cap} overflows: max neighbor count is {most}; "
                "pass a larger k_cap or let it default")
        k = int(k * 1.5) + 8


def _neighbor_rows(pos, box, radius: float, half: bool, k_cap: int | None,
                   layout: str, chunk: int, backend: str, device):
    """(idx, cnt) of ``neighbor_list``: on the host from the dense path's
    decode, on ``device`` from the sweep."""
    if backend not in ("auto", "xla", "dense"):
        raise ValueError(f"backend={backend!r}")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "neighbor_list runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run the plain versions")
    box = _as_box(box)
    pos = box.wrap(torch.as_tensor(pos, dtype=torch.float32).to(device))
    n = pos.shape[0]
    if n == 0:
        k = k_cap if k_cap is not None else 8
        return (torch.zeros((0, k), dtype=torch.int32),
                torch.zeros((0,), dtype=torch.int32))
    if use_dense(backend, device, n, box.L, radius):
        return _dense_neighbor_list(pos, box, radius, half, k_cap)
    return _sweep_neighbor_list(pos, box, radius, half, k_cap, layout, chunk)


def neighbor_list(pos, box, radius: float, *, half: bool = False,
                  k_cap: int | None = None, layout: str = "rowmajor",
                  chunk: int = 2048, backend: str = "auto", device="cuda"):
    """Fixed-capacity padded neighbour lists for arbitrary positions.

    Args:
      pos:    (N, 3) positions, a tensor on any device or an array; taken as
              float32 on ``device`` and wrapped into [0, L) internally.
      box:    periodic cube side length L, or a ``Box``.
      radius: search radius (e.g. rc + skin).
      half:   True → Newton-3 half lists: each unordered pair appears in
              exactly ONE row (attribution follows the engine's internal
              order, not index order — canonicalize with ``pair_list`` if you
              need i < j). False → full symmetric rows.
      k_cap:  fixed row capacity K. Default: the density estimate grown on
              overflow (sweep), or the largest count rounded up to a multiple
              of 8 (dense). If given explicitly, an overflow raises
              ``ValueError`` (the caller asked for a hard shape contract).
      layout: "rowmajor" or "morton" spatial sort key of the sweep: the same
              output, another internal order ("dense" has its own order).
      chunk:  rows per sweep chunk (peak memory O(chunk * 27 * cell_cap)).
      backend: "auto" (default), "xla" or "dense". "xla" is the bin + 27-cell
              sweep (the JAX package's name for it), which takes the O(N^2)
              oracle where the box holds fewer than 3 cells of ``radius`` a
              side; "dense" is the dense engine + host-side mask decode, and
              raises on such a box. "auto" takes "dense" off the CPU at
              N >= DENSE_API_MIN_N on a box of at least 3 cells a side, else
              "xla" (``use_dense``).
      device: where the build runs: the card by default (raises without
              one); ``"cpu"`` runs the kernels' plain versions.

    Returns (idx, cnt) on ``device``: ``idx`` (N, K) int32, row i = neighbour
    indices of particle i in the caller's order, padded with the sentinel N;
    ``cnt`` (N,) int32 true neighbour counts.
    """
    idx, cnt = _neighbor_rows(pos, box, radius, half, k_cap, layout, chunk,
                              backend, device)
    return idx.to(device), cnt.to(device)


def pair_list(pos, box, radius: float, *, k_cap: int | None = None,
              layout: str = "rowmajor", chunk: int = 2048,
              backend: str = "auto", device="cuda"):
    """Explicit half pair list (i, j) with i < j, each unordered pair once:
    numpy int32 arrays, the host-side expansion of
    ``neighbor_list(..., half=True)`` with the same arguments. Total length
    == the exact pair count."""
    idx, _ = _neighbor_rows(pos, box, radius, True, k_cap, layout, chunk,
                            backend, device)
    idx = idx.cpu().numpy()
    n = idx.shape[0]
    keep = idx < n
    i = np.nonzero(keep)[0]  # row of every kept entry, row-major
    j = idx[keep].astype(np.int64)
    return (np.minimum(i, j).astype(np.int32),
            np.maximum(i, j).astype(np.int32))


__all__ = ["DENSE_API_MIN_N", "neighbor_list", "pair_list", "use_dense"]
