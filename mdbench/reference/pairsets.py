"""Read the program's outputs as sets of pairs, and compare them with the
reference's.

The list build's artifact is packed hit masks over the dense cell layout; its
bit semantics are the documented format of the program's output (the port's
``ops/decode.py``), copied here so that the yardstick does not move with the
program: bit b of word w at [k, w, r, x, lane] says that own slot 32 w + b of
cell (z = r // mc, y = r % mc, x) has as a half neighbour slot lane % cap of
cell ((z + dz) % mc, (y + dy) % mc, (x + lane // cap - 1) % mc), where
(dz, dy) is the k-th of ``HALF_OFFSETS5``. Each unordered pair sets one bit.
"""

from __future__ import annotations

import torch

HALF_OFFSETS5 = [(0, 0), (0, 1), (1, -1), (1, 0), (1, 1)]
MASK_BITS = 32


def mask_pair_keys(masks: torch.Tensor, pid: torch.Tensor, mc: int, cap: int,
                   n: int) -> tuple[torch.Tensor, int]:
    """(keys, bad): the sorted keys min * n + max of the particle ids of
    every pair that the masks (5, words, mc*mc, mc, 3cap) set, over the slot
    ids ``pid`` (mc*mc, mc, cap); ``bad`` counts the bits that name an own
    slot past ``cap`` or an empty slot."""
    dev = masks.device
    pidf = pid.reshape(-1).to(torch.int64)
    shifts = torch.arange(MASK_BITS, dtype=torch.int32, device=dev)
    keys, bad = [], 0
    for k, (dz, dy) in enumerate(HALF_OFFSETS5):
        for w in range(masks.shape[1]):
            m = masks[k, w]
            r, x, lane = torch.nonzero(m, as_tuple=True)
            bits = (m[r, x, lane][:, None] >> shifts) & 1  # (E, 32)
            e, b = torch.nonzero(bits, as_tuple=True)
            r, x, lane = r[e], x[e], lane[e]
            slot = MASK_BITS * w + b
            over = slot >= cap
            bad += int(over.sum())
            own = (r * mc + x) * cap + torch.clamp(slot, max=cap - 1)
            z, y = r // mc, r % mc
            pz, py = (z + dz) % mc, (y + dy) % mc
            px = (x + lane // cap - 1) % mc
            partner = ((pz * mc + py) * mc + px) * cap + lane % cap
            a, c = pidf[own], pidf[partner]
            ok = (a >= 0) & (c >= 0) & ~over
            bad += int((~ok & ~over).sum())
            a, c = a[ok], c[ok]
            keys.append(torch.minimum(a, c) * n + torch.maximum(a, c))
    return torch.sort(torch.cat(keys)).values, bad


def mismatches(got: torch.Tensor, ref: torch.Tensor,
               band: torch.Tensor) -> tuple[int, int]:
    """(outside, inside): the keys in one sorted set and not the other (a
    key ``got`` holds twice counts once more), outside the band's keys and
    inside them."""
    dups = got.numel() - torch.unique_consecutive(got).numel()
    diff = torch.cat([got[~torch.isin(got, ref)], ref[~torch.isin(ref, got)]])
    in_band = torch.isin(diff, band)
    return int((~in_band).sum()) + dups, int(in_band.sum())
