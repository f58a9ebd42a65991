"""The refinement-engine seam: per-level force models as pluggable steps.

The multilevel driver (coarsen → place → refine, core/multilevel.py) fixes
the hierarchy and treats the per-level refinement as a black box; a
``RefinementEngine`` supplies it, as in the JAX package's ``core/engine.py``:

  * ``init_state``    — per-level setup: the k-hop neighbor lists for
                        ``mode="neighbor"``, zero dummies otherwise;
  * ``refine``        — run the level's iterations from ``pos0``;
  * ``lane_schedule`` — the scalars the step anneals each iteration, length
                        ``sched_k``: GiLA's (temp0, temp_decay), and
                        maxent-stress adds (alpha0, alpha_decay);
  * ``tune``          — a hook over the freshly built ``LevelSchedule``.

PyTorch runs eagerly, so ``refine`` takes the place of the JAX package's
jit builders (``build_refine``) and there is no compile cache to key.

Engines register themselves in ``ENGINES`` by name; ``get_engine`` imports
``core/stress.py`` on first use, so the GiLA-only path never loads it.
"""
from __future__ import annotations

import torch

from repro_torch.core import gila
from repro_torch.graphs.graph import PaddedGraph


class RefinementEngine:
    """One per-level refinement force model (see module docstring)."""

    #: registry id; also the ``LevelSchedule.engine`` value
    name: str = "?"
    #: length of the ``lane_schedule`` tuple
    sched_k: int = 2

    def lane_schedule(self, sched) -> tuple:
        """The annealing scalars of one level, length ``sched_k``."""
        raise NotImplementedError

    def tune(self, sched):
        """Hook over a freshly built ``LevelSchedule``; default: unchanged."""
        return sched

    def init_state(self, g: PaddedGraph, sched, seed: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-level (nbr_idx, nbr_mask): the k-hop lists for neighbor mode
        (a host build, the same for every engine so forces are comparable
        on identical lists), zero dummies for the dense modes."""
        if sched.mode == "neighbor":
            return gila.build_level_neighbors(g, sched.k, sched.cap,
                                              seed=seed)
        return (torch.zeros((g.n_pad, 1), dtype=torch.int32, device=g.device),
                torch.zeros((g.n_pad, 1), dtype=torch.bool, device=g.device))

    def refine(self, g: PaddedGraph, pos0, nbr_idx, nbr_mask, sched, *,
               ideal_len: float, rep_const: float,
               min_dist: float = 1e-3) -> torch.Tensor:
        """``sched.iters`` iterations from ``pos0`` → positions [n_pad, 2]."""
        raise NotImplementedError


class GilaEngine(RefinementEngine):
    """Fruchterman–Reingold with k-hop-restricted repulsion (paper §3.4);
    the per-iteration math lives in ``gila.layout_iteration``."""

    name = "gila"
    sched_k = 2                     # (temp0, temp_decay)

    def lane_schedule(self, sched) -> tuple:
        return (sched.temp0, sched.temp_decay)

    def refine(self, g, pos0, nbr_idx, nbr_mask, sched, *, ideal_len,
               rep_const, min_dist=1e-3):
        temp0, temp_decay = self.lane_schedule(sched)
        return gila.gila_layout(
            g, pos0, nbr_idx, nbr_mask, mode=sched.mode, iters=sched.iters,
            temp0=temp0, temp_decay=temp_decay, ideal_len=ideal_len,
            rep_const=rep_const, min_dist=min_dist, grid_dim=sched.grid_dim,
            cell_cap=sched.cell_cap)


# -- registry -----------------------------------------------------------------

ENGINES: dict[str, RefinementEngine] = {}


def register(eng: RefinementEngine) -> RefinementEngine:
    ENGINES[eng.name] = eng
    return eng


def get_engine(name: str) -> RefinementEngine:
    """Engine by registry id; 'stress' loads core/stress.py on first use."""
    if name not in ENGINES and name == "stress":
        import repro_torch.core.stress  # noqa: F401  — registers on import
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown refinement engine {name!r}; "
                         f"known: {sorted(ENGINES)}") from None


register(GilaEngine())
