"""Row-capacity estimate for fixed-shape padded neighbour lists (the K
estimate of ``md_neighbor_list_tpu/core/capacity.py``; its cell estimate and
growth record come with the engine that uses them).

The estimate is the ideal-gas mean inflated by a Poisson fluctuation margin
and a multiplicative safety factor, rounded up to a multiple of ``align``. It
is a starting point only: the consumer detects an overflow and grows, it
never truncates.
"""

from __future__ import annotations

import math


def estimate_neighbors(rho: float, rs: float, half_list: bool,
                       safety: float = 1.2, sigmas: float = 8.0,
                       align: int = 8) -> int:
    """K, the padded neighbour slots per particle, for density ``rho`` and
    search radius ``rs``. ``sigmas`` is generous on purpose (the largest of
    ~1e5 Poisson counts sits many sigmas above the mean)."""
    mean = rho * (4.0 / 3.0) * math.pi * rs**3
    if half_list:
        mean *= 0.5
    upper = mean + sigmas * math.sqrt(max(mean, 1.0))
    return (int(upper * safety) + align) // align * align
