"""Per-level parameter schedules (paper §3.4 dynamic tuning of GiLA).

Coarse levels get more quality (more iterations, hotter start), fine
levels get speed. Repulsion mode by level size:

  n ≤ exact_threshold   →  "exact"     all-pairs (kernels/nbody)
  n ≤ grid_threshold    →  "neighbor"  capped k-hop lists (kernels/neighbor_force)
  n > grid_threshold    →  "grid"      grid-bucketed approximation (kernels/grid_force)

The JAX package's ``core/schedule.py``: ``grid_dim``/``cell_cap`` come from
the level's padded size ``n_pad``, so the port pads exactly as it does.
"""
from __future__ import annotations

import dataclasses

from repro_torch.kernels.grid_force.ops import choose_grid


def paper_k_schedule(m: int) -> int:
    """k(m) exactly as tuned in paper §3.4."""
    if m < 1_000:
        return 6
    if m < 5_000:
        return 5
    if m < 10_000:
        return 4
    if m < 100_000:
        return 3
    if m < 1_000_000:
        return 2
    return 1


@dataclasses.dataclass(frozen=True)
class LevelSchedule:
    k: int               # repulsion horizon (paper's table)
    cap: int             # neighbor-list cap (message-load bound)
    iters: int
    temp0: float
    temp_decay: float
    mode: str            # "exact" | "neighbor" | "grid"
    grid_dim: int = 0    # G (grid mode only): G×G spatial cells
    cell_cap: int = 0    # bucket capacity per cell (grid mode only)


def make_schedule(level: int, n_levels: int, n: int, m: int,
                  *, n_pad: int, exact_threshold: int = 2048,
                  grid_threshold: int = 32768,
                  coarsest_iters: int = 300, finest_iters: int = 50,
                  ideal_len: float = 1.0) -> LevelSchedule:
    """level = 0 is the input graph; level = n_levels-1 is the coarsest;
    ``n_pad`` is the level's padded size, which keys the grid."""
    k = paper_k_schedule(m)
    cap = {1: 32, 2: 64, 3: 128, 4: 192, 5: 256, 6: 256}[k]
    if n_levels <= 1:
        iters = coarsest_iters
    else:
        frac = level / (n_levels - 1)           # 1 at coarsest
        iters = int(finest_iters * (coarsest_iters / finest_iters) ** frac)
    extent = ideal_len * max(n, 4) ** 0.5
    temp0 = extent * (0.25 if level == n_levels - 1 else 0.06)
    grid_dim = cell_cap = 0
    if n <= exact_threshold:
        mode = "exact"
    elif n <= grid_threshold:
        mode = "neighbor"
    else:
        mode = "grid"
        grid_dim, cell_cap = choose_grid(n_pad)
    return LevelSchedule(
        k=k, cap=cap, iters=max(iters, 10), temp0=temp0,
        temp_decay=0.985 if level == n_levels - 1 else 0.96,
        mode=mode, grid_dim=grid_dim, cell_cap=cell_cap)
