"""Consumer API of the packed neighbour-list artifact (PyTorch port of
``md_neighbor_list_tpu/ops/decode.py``).

The dense engine's list build (``dense_force.dense_lists_half``) emits the
neighbour list in cluster-compressed form: per-offset-row bitmasks packed
over the own-slot axis, plus per-slot half counts. A user of a neighbour-list
library expects explicit pairs or fixed-capacity padded per-particle rows;
this module is the bridge:

    counts, masks = dense_lists_half(state.pos, spec, rs)
    i, j = decode_pairs(masks, state.pid, spec)          # pair list
    idx, cnt = masks_to_padded(masks, state.pid, spec)   # (N, K) rows

Both decoders are host-side: decoding is an O(pairs) irregular expansion and
its consumers (I/O, analysis, other MD tools) are on the host. ``masks`` and
``pid`` may be the port's tensors, on any device (they are copied to the host
here), or numpy arrays; the results are numpy arrays. ``impl="native"``, the
default, is the C++ streaming walker (``csrc/decode.cpp`` through
``utils/native.py``, built at first use; a failed build raises);
``impl="numpy"`` is the pure-numpy path, the parity reference. There is no
automatic choice between them.

Bit semantics (the single source of truth): bit ``b`` of word ``w`` at index
``[k, w, r, x, lane]`` says own slot ``i = MASK_BITS*w + b`` of cell
``(z=r//mc, y=r%mc, x)`` has, as a half neighbour, slot ``lane % cap`` of
cell ``(z+dz) % mc, (y+dy) % mc, (x + lane//cap - 1) % mc`` where
``(dz, dy) = HALF_OFFSETS5[k]``. Each unordered pair sets exactly one bit.
"""

from __future__ import annotations

import numpy as np
import torch

from md_neighbor_list_tpu_torch.ops.dense_force import HALF_OFFSETS5, MASK_BITS
from md_neighbor_list_tpu_torch.utils import native


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _check_impl(impl: str) -> None:
    if impl not in ("native", "numpy"):
        raise ValueError(f"impl={impl!r}")


def _decode_slots(masks, spec):
    """Yield (own_flat, partner_flat) int64 slot-index arrays, one batch per
    (offset row, word, bit) with any set bits. Flat index = (r*mc + x)*cap
    + slot over the (R, mc, cap) dense layout.

    One full-volume ``nonzero`` pass per (offset row, word); the per-bit
    loops then run over the nonzero entries only."""
    m = _host(masks)  # (5, words, R, mc, 3cap)
    mc, cap = spec.mc, spec.cap
    for k, (dz, dy) in enumerate(HALF_OFFSETS5):
        for w in range(m.shape[1]):
            r, x, lane = np.nonzero(m[k, w])
            if r.size == 0:
                continue
            vals = m[k, w][r, x, lane]
            z, y = r // mc, r % mc
            prow = ((z + dz) % mc) * mc + (y + dy) % mc
            px = (x + lane // cap - 1) % mc
            own_base = (r.astype(np.int64) * mc + x) * cap
            partner = (prow.astype(np.int64) * mc + px) * cap + lane % cap
            for b in range(min(MASK_BITS, cap - MASK_BITS * w)):
                sel = np.nonzero((vals >> b) & 1)[0]
                if sel.size == 0:
                    continue
                yield own_base[sel] + MASK_BITS * w + b, partner[sel]


def _decode_pid_pairs(masks, pid, spec, impl: str = "native"):
    """(own pid, partner pid) arrays for every set bit, preserving the
    kernel's Newton-3 attribution. Raises ValueError if a set bit points at
    an empty slot."""
    _check_impl(impl)
    masks, pid = _host(masks), _host(pid)
    if impl == "native":
        return native.decode_half(masks, pid, spec.mc, spec.cap)
    flat = pid.reshape(-1)
    owns, partners = [], []
    for own, partner in _decode_slots(masks, spec):
        pi, pj = flat[own], flat[partner]
        if (pi < 0).any() or (pj < 0).any():
            raise ValueError(native.EMPTY_SLOT)
        owns.append(pi)
        partners.append(pj)
    if not owns:
        z = np.zeros((0,), np.int32)
        return z, z.copy()
    return np.concatenate(owns), np.concatenate(partners)


def decode_pairs(masks, pid, spec, impl: str = "native"):
    """Decode the packed masks to an explicit half pair list.

    Args:
      masks: (5, words, R, mc, 3cap) i32 from ``dense_lists_half``.
      pid:   (R, mc, cap) i32 particle ids of the SAME dense state the masks
             were built from (slot -> global particle id).
      spec:  the DenseSpec of that state.
      impl:  "native" (C++ walker) or "numpy".

    Returns (i, j): int32 arrays of global particle ids with i < j
    elementwise, each unordered pair exactly once (the total length equals
    the engine's pair count)."""
    own, partner = _decode_pid_pairs(masks, pid, spec, impl)
    return (np.minimum(own, partner).astype(np.int32),
            np.maximum(own, partner).astype(np.int32))


def masks_to_padded(masks, pid, spec, n: int | None = None,
                    k_cap: int | None = None, impl: str = "native",
                    full: bool = False):
    """Convert the packed masks to fixed-capacity padded neighbour rows.

    Args:
      masks, pid, spec, impl: as in ``decode_pairs``.
      n:     particle count / row count (default: ``max(pid) + 1`` — not the
             number of valid slots, which undercounts whenever the state's
             pids are not the dense range 0..n-1).
      k_cap: row capacity K (default: the largest per-particle count,
             rounded up to a multiple of 8, at least 8). An explicit k_cap
             below the largest count raises ValueError.
      full:  False — half rows: row i holds the j's of the pairs the kernel's
             Newton-3 dedup attributed to i, each unordered pair stored once
             (sum(cnt) == pair count). True — every pair stored in both rows
             (sum(cnt) == 2 x pair count), the shape a scatter-free force
             loop consumes.

    Returns (idx, cnt): idx (N, K) i32 rows of global neighbour ids padded
    with the sentinel N; cnt (N,) i32 neighbour counts."""
    _check_impl(impl)
    masks, pid = _host(masks), _host(pid)
    if n is None:
        n = max(int(pid.max()) + 1, 0)
    if impl == "native" and n > 0:
        # single-pass emitter: the first pass guesses K; a too-small guess
        # reports the true largest count and one more pass finishes
        guess = k_cap if k_cap is not None else 64
        idx, cnt, maxc = native.decode_half_padded(
            masks, pid, spec.mc, spec.cap, n, guess, full)
        if k_cap is not None:
            if maxc > k_cap:
                raise ValueError(f"k_cap={k_cap} < max half count {maxc}")
            return idx, cnt
        k = max(8, -(-maxc // 8) * 8)
        if k > guess:
            idx, cnt, maxc = native.decode_half_padded(
                masks, pid, spec.mc, spec.cap, n, k, full)
        elif k < guess:
            idx = np.ascontiguousarray(idx[:, :k])
        return idx, cnt
    pi, pj = _decode_pid_pairs(masks, pid, spec, impl)
    pi = pi.astype(np.int64)
    pj = pj.astype(np.int64)
    if full:
        pi, pj = np.concatenate([pi, pj]), np.concatenate([pj, pi])
    if pi.size and max(int(pi.max()), int(pj.max())) >= n:
        raise ValueError(
            f"n={n} is smaller than max decoded pid "
            f"{max(int(pi.max()), int(pj.max()))}")
    cnt = np.bincount(pi, minlength=n).astype(np.int32)
    max_cnt = int(cnt.max()) if cnt.size else 0  # .max() raises on n == 0
    if k_cap is None:
        k_cap = max(8, -(-max_cnt // 8) * 8)
    elif max_cnt > k_cap:
        raise ValueError(f"k_cap={k_cap} < max half count {max_cnt}")
    idx = np.full((n, k_cap), n, np.int32)
    order = np.argsort(pi, kind="stable")
    pi, pj = pi[order], pj[order]
    slot = np.arange(pi.size) - np.concatenate(([0], np.cumsum(cnt)))[pi]
    idx[pi, slot] = pj
    return idx, cnt
