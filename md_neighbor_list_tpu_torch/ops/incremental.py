"""Incremental dense rebuild: sort only the particles that changed cell
(PyTorch port of ``md_neighbor_list_tpu/ops/incremental.py``).

Between rebuilds particles move at most skin/2, so at a rebuild only a few
percent of them ("movers") have left their cell. The incremental rebuild:

  1. wraps the positions and keys every slot; a stayer is a valid slot whose
     key is the cell it sits in, a mover any other valid slot;
  2. sorts the mover stream (stayers and empty slots take the beyond-last
     key) and expands it with the K1 kernel into a dense mover state;
  3. checks the JAX package's window predicate on the mover stream's row
     starts (``window_overflow``);
  4. stitches each cell in the K8 kernel (``merge``): its stayers compacted to
     a prefix in slot order, its movers behind them, the rest parked.

Two failure modes, both detected and never silent:

  window overflow  the JAX expand reads each group of ``MOVER_G`` rows
                   through a ``MOVER_WINDOW``-record window and drops what
                   lies beyond it. The port's K1 has no window and drops
                   nothing, but its merged state is not trusted when the
                   predicate holds: the caller takes the full rebuild, so
                   that both packages take the same branch on the same input.
  cell overflow    stayers + movers of a cell beyond cap: the merge drops the
                   movers past cap, the caller's particle count sees the loss
                   and grows cap, as on the full path.

Against the full rebuild the result is the same partition of particles into
cells, not the same slot order inside a cell (the full sort orders a cell by
the records' previous slots; here stayers come first). Every sweep kernel is
order-independent in its pairs; force sums differ by f32 rounding.
"""

from __future__ import annotations

import numpy as np
import torch

from md_neighbor_list_tpu_torch.ops import _cuda
from md_neighbor_list_tpu_torch.ops.dense_cells import (DenseState,
                                                        _park_step, cell_keys,
                                                        park_lattice,
                                                        sort_expand)

MOVER_G = 2  # cell rows per mover-expand group in the JAX package
MOVER_WINDOW = 512  # records per group's window in the JAX package


def own_cell_keys(spec, device="cuda") -> torch.Tensor:
    """(R, mc, cap) i32: the key of the cell each slot belongs to."""
    r = torch.arange(spec.rows, dtype=torch.int32, device=device)
    x = torch.arange(spec.mc, dtype=torch.int32, device=device)
    key = r[:, None] * spec.mc + x[None, :]
    return key[:, :, None].expand(spec.rows, spec.mc, spec.cap)


def window_overflow(row_start: torch.Tensor) -> torch.Tensor:
    """0-d bool: would the JAX mover expand drop records? Its groups are
    ``MOVER_G`` consecutive rows (and a shorter tail group at odd R); each
    reads its records from its first row start rounded down to 128 through a
    ``MOVER_WINDOW``-record window, so a group whose span from there exceeds
    the window loses records."""
    g_start = row_start[:-1:MOVER_G]
    g_end = row_start[MOVER_G::MOVER_G]
    if g_end.shape[0] < g_start.shape[0]:  # tail group
        g_end = torch.cat([g_end, row_start[-1:]])
    span = torch.max(g_end - (g_start // 128) * 128)
    return span > MOVER_WINDOW


# --------------------------------------------------------------- K8: merge
def merge_plain(state_w: DenseState, spid: torch.Tensor, movers: DenseState,
                spec) -> DenseState:
    """Plain PyTorch version of ``merge``, by gathers: output slot d of a cell
    takes the stayer of rank d while d < n_stay (a stable sort of the slots
    by "not a stayer" lists the stayers first, in slot order), then mover slot
    d - n_stay where that slot holds a mover, else the park lattice."""
    ncell, cap = spec.ncells, spec.cap
    dev = spid.device
    sp = spid.reshape(ncell, cap)
    mp = movers.pid.reshape(ncell, cap)
    stay = sp >= 0
    order = torch.sort((~stay).to(torch.int32), dim=1, stable=True).indices
    n_stay = stay.sum(dim=1, keepdim=True)
    slot = torch.arange(cap, device=dev)[None, :]
    from_stay = slot < n_stay
    m = torch.clamp(slot - n_stay, min=0)
    from_mov = ~from_stay & (torch.gather(mp, 1, m) >= 0)

    def pick(s_val, m_val, fill):
        return torch.where(from_stay, torch.gather(s_val, 1, order),
                           torch.where(from_mov, torch.gather(m_val, 1, m),
                                       fill))

    shape = (spec.rows, spec.mc, cap)
    park = park_lattice(spec, dev).reshape(3, ncell, cap)
    pos = torch.stack([pick(state_w.pos[c].reshape(ncell, cap),
                            movers.pos[c].reshape(ncell, cap), park[c])
                       for c in range(3)])
    vel = torch.stack([pick(state_w.vel[c].reshape(ncell, cap),
                            movers.vel[c].reshape(ncell, cap),
                            torch.zeros((), device=dev)) for c in range(3)])
    pid = pick(sp, mp, torch.full((), -1, dtype=torch.int32, device=dev))
    return DenseState(pos=pos.reshape((3,) + shape),
                      vel=vel.reshape((3,) + shape), pid=pid.reshape(shape))


def merge(state_w: DenseState, spid: torch.Tensor, movers: DenseState,
          spec) -> DenseState:
    """Stitch the new state per cell: the stayers of ``state_w`` (slots where
    ``spid`` (R, mc, cap) i32 is >= 0) compacted to a prefix in slot order,
    then the cell's movers (``movers``: a cell's movers in its first slots, as
    ``sort_expand`` leaves them), movers past cap dropped; the other slots get
    the park lattice, zero velocity and pid -1.

    Kernel: ``csrc/merge.cu``, replacing ``_merge_kernel`` of
    md_neighbor_list_tpu/ops/incremental.py (the TPU body's two calls, for pos
    and for vel, are one launch here). Bound by bytes: each slot's stayer pid,
    each particle's pos and vel once from the side it comes from, each mover's
    pid and one end-of-movers pid per cell are read, and each slot's 28 bytes
    written; a warp per cell scatters its stayers by ballot rank and pulls the
    movers behind them. Equal to ``merge_plain`` bitwise. pid stays
    i32 (the TPU body carries it through f32, exact below 2^24). CPU tensors
    take ``merge_plain``."""
    if not spid.is_cuda:
        return merge_plain(state_w, spid, movers, spec)
    args = (state_w.pos, state_w.vel, spid, movers.pos, movers.vel,
            movers.pid)
    _cuda.check_cuda(*args)
    shape = (spec.rows, spec.mc, spec.cap)
    for t, tail in zip(args, ((3,), (3,), (), (3,), (3,), ())):
        want = torch.int32 if not tail else torch.float32
        if t.shape != tail + shape or t.dtype != want:
            raise ValueError(f"merge: expected {want} of shape "
                             f"{tail + shape}, got {t.dtype} {tuple(t.shape)}")
    pos = torch.empty_like(state_w.pos)
    vel = torch.empty_like(state_w.vel)
    pid = torch.empty_like(spid)
    _cuda.launch("merge", *args, pos, vel, pid, spec.rows, spec.mc, spec.cap,
                 _park_step(spec))
    return DenseState(pos=pos, vel=vel, pid=pid)


# ------------------------------------------------------------ the rebuild
def merge_inputs(state: DenseState, spec):
    """Steps 1-2 of the incremental rebuild: ``((state_w, spid, movers),
    row_start)`` — the wrapped state, its pid with every slot but the
    stayers' set to -1, the expanded mover stream, and that stream's row
    starts."""
    state_w = state._replace(pos=torch.remainder(state.pos, spec.L))
    keys = cell_keys(state_w, spec)  # empty slots: the beyond-last key
    stay = keys == own_cell_keys(spec, keys.device)
    mover_keys = torch.where(state.valid() & ~stay, keys,
                             torch.full_like(keys, spec.ncells))
    chans = torch.cat([state_w.pos.reshape(3, -1),
                       state_w.vel.reshape(3, -1)])
    movers, row_start = sort_expand(mover_keys.reshape(-1), chans,
                                    state.pid.reshape(-1), spec)
    spid = torch.where(stay, state.pid, torch.full_like(state.pid, -1))
    return (state_w, spid, movers), row_start


def rebuild_dense_incremental(state: DenseState,
                              spec) -> tuple[DenseState, torch.Tensor]:
    """Incremental rebuild: (new_state, inc_overflow). When ``inc_overflow``
    (a 0-d bool tensor) is True the caller must take ``rebuild_dense``
    instead, as the JAX engine does. Cell overflow is, as on the full path,
    the caller's count of valid slots."""
    args, row_start = merge_inputs(state, spec)
    return merge(*args, spec), window_overflow(row_start)


def rebuild_reference_incremental(state: DenseState, spec) -> DenseState:
    """Order-exact numpy twin of the incremental result, computed another
    way: one stable sort of all valid records by (destination cell, stayer
    before mover, previous slot), each cell's first cap records kept. The
    correctness oracle of ``rebuild_dense_incremental`` and ``merge``."""
    dev = state.pid.device
    L = np.float32(spec.L)
    pos = np.mod(state.pos.reshape(3, -1).cpu().numpy(), L)
    vel = state.vel.reshape(3, -1).cpu().numpy()
    pid = state.pid.reshape(-1).cpu().numpy()
    inv = np.float32(1.0 / spec.cell_size)
    mc, cap, S = spec.mc, spec.cap, spec.slots
    coords = np.clip(np.floor(pos * inv).astype(np.int64), 0, mc - 1)
    key = coords[0] + mc * (coords[1] + mc * coords[2])
    slot = np.arange(S)
    own = slot // cap
    valid = pid >= 0
    mover = valid & (key != own)
    src = np.nonzero(valid)[0]
    order = np.lexsort((src, mover[src], key[src]))  # last key sorts first
    src = src[order]
    cell = key[src]
    first = np.searchsorted(cell, cell, side="left")
    rank = np.arange(src.shape[0]) - first
    keep = rank < cap
    dst = cell[keep] * cap + rank[keep]
    src = src[keep]

    out_pos = park_lattice(spec, "cpu").reshape(3, -1).numpy().copy()
    out_vel = np.zeros((3, S), np.float32)
    out_pid = np.full((S,), -1, np.int32)
    out_pos[:, dst] = pos[:, src]
    out_vel[:, dst] = vel[:, src]
    out_pid[dst] = pid[src]
    shape = (spec.rows, mc, cap)
    return DenseState(
        pos=torch.from_numpy(out_pos.reshape((3,) + shape)).to(dev),
        vel=torch.from_numpy(out_vel.reshape((3,) + shape)).to(dev),
        pid=torch.from_numpy(out_pid.reshape(shape)).to(dev))
