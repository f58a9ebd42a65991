"""Per-level refinement of the multilevel driver on pow2-padded levels.

The JAX package's ``core/bucketing.py:refine_level``: a dispatch through the
level's refinement engine (``sched.engine``, core/engine.py), which builds
its per-level state and then runs the level's iterations. PyTorch runs
eagerly, so there is no compile cache to key: the level's tensors go
straight to the engine.
"""
from __future__ import annotations

import torch

from repro_torch.core.engine import get_engine
from repro_torch.graphs.graph import PaddedGraph


def refine_level(g: PaddedGraph, pos0, sched, *, ideal_len: float,
                 rep_const: float, min_dist: float = 1e-3,
                 seed: int = 0) -> torch.Tensor:
    """Refine one level for ``sched.iters`` iterations from ``pos0``."""
    eng = get_engine(sched.engine)
    nbr_idx, nbr_mask = eng.init_state(g, sched, seed)
    return eng.refine(g, pos0.to(device=g.device, dtype=torch.float32),
                      nbr_idx, nbr_mask, sched, ideal_len=ideal_len,
                      rep_const=rep_const, min_dist=min_dist)
