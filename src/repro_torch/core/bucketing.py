"""Per-level refinement of the multilevel driver on pow2-padded levels.

The JAX package's ``core/bucketing.py:refine_level`` with the semantics of
its GiLA engine (``core/engine.py``: ``init_state`` builds the k-hop lists in
neighbor mode and zero dummies otherwise; the step anneals ``temp0`` by
``temp_decay`` in float32). PyTorch runs eagerly, so there is no compile
cache to key: the level's tensors go straight to ``gila.gila_layout``.
"""
from __future__ import annotations

import torch

from repro_torch.core import gila
from repro_torch.graphs.graph import PaddedGraph


def init_state(g: PaddedGraph, sched, seed: int
               ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-level (nbr_idx, nbr_mask): the k-hop lists for neighbor mode,
    zero dummies for the dense modes."""
    if sched.mode == "neighbor":
        return gila.build_level_neighbors(g, sched.k, sched.cap, seed=seed)
    return (torch.zeros((g.n_pad, 1), dtype=torch.int32, device=g.device),
            torch.zeros((g.n_pad, 1), dtype=torch.bool, device=g.device))


def refine_level(g: PaddedGraph, pos0, sched, *, ideal_len: float,
                 rep_const: float, min_dist: float = 1e-3,
                 seed: int = 0) -> torch.Tensor:
    """Refine one level for ``sched.iters`` iterations from ``pos0``."""
    nbr_idx, nbr_mask = init_state(g, sched, seed)
    return gila.gila_layout(
        g, pos0.to(device=g.device, dtype=torch.float32), nbr_idx, nbr_mask,
        mode=sched.mode, iters=sched.iters, temp0=sched.temp0,
        temp_decay=sched.temp_decay, ideal_len=ideal_len,
        rep_const=rep_const, min_dist=min_dist, grid_dim=sched.grid_dim,
        cell_cap=sched.cell_cap)
