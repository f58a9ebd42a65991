"""Maxent-stress refinement engine (PAPERS.md: Meyerhenke/Nöllenburg/Schulz,
*Drawing Large Graphs by Multilevel Maxent-Stress Optimization*), the JAX
package's ``core/stress.py`` on torch tensors.

Edge e = (j → i) wants i at distance ℓ_e = max(ewt_e, 1e-6)·L from j, so it
votes for the point on the j→i ray at that distance, with weight
w_e = 1/ℓ_e². The maxent regularizer adds a repulsive entropy term whose
strength α anneals from ``ALPHA0`` by a total factor ``ALPHA_SHRINK`` over
the level's iterations. The local (Jacobi) iteration per vertex i:

    x_i ← ( Σ_e w_e · tgt_e  +  α · r_i ) / ρ_i ,    ρ_i = Σ_e w_e

with r_i the repulsion through the SAME exact / neighbor / grid kernels GiLA
uses (``gila.repulsion``), passing α·C in the kernels' repulsion-constant
slot: stress has no kernel of its own. Vertices with ρ_i = 0 (padding,
isolated) keep their position; the displacement is clamped by the cooling
temperature exactly like GiLA's update.

The hierarchy compounds edge weights level to level
(``solar_merger.next_level``), so a coarse edge's ℓ_e is the accumulated
fine-path length: weighted target distances come from the hierarchy.

Temperature and α each anneal in float32 (``gila.temperatures``), and α·C
is rounded to float32 once per iteration, as the JAX package's traced
``alpha * C`` is.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine as engine_mod
from repro_torch.core import gila
from repro_torch.graphs.graph import PaddedGraph, edge_gather, segment_sum
from repro_torch.kernels import _build

#: entropy-term annealing: α starts at ALPHA0 and decays geometrically by a
#: TOTAL factor of ALPHA_SHRINK over the level's iteration budget (the JAX
#: package's values, picked there by a mesh-suite scan, EXPERIMENTS.md
#: §Stress)
ALPHA0 = 0.05
ALPHA_SHRINK = 0.008


def alpha_schedule(iters: int) -> tuple[float, float]:
    """(α₀, per-iteration multiplicative decay) reaching α₀·ALPHA_SHRINK at
    the level's last iteration."""
    return ALPHA0, float(ALPHA_SHRINK ** (1.0 / max(int(iters), 1)))


def stress_terms(g: PaddedGraph, L: float):
    """Position-independent per-edge terms, hoisted out of the iteration
    loop: target lengths ℓ_e, weights w_e = 1/ℓ_e² (0 on padding), and the
    per-vertex weight sum ρ."""
    ell = torch.clamp_min(g.ewt, 1e-6) * L
    we = torch.where(g.emask, 1.0 / (ell * ell), 0.0)
    rho = segment_sum(we, g.dst_l, g.n_pad + 1)[:g.n_pad]
    return ell, we, rho


def stress_iteration(g: PaddedGraph, pos, nbr_idx, nbr_mask, ell, we, rho,
                     dst_clip, temp: float, ca: float, *, L: float,
                     min_dist: float, mode: str, grid_dim: int = 0,
                     cell_cap: int = 0) -> torch.Tensor:
    """One maxent-stress Jacobi iteration; ``ca`` = α·C, rounded to float32;
    ``dst_clip`` is ``dst`` clamped to [0, n_pad), hoisted out of the loop
    with ``stress_terms``."""
    n_pad = g.n_pad
    _, md2 = _build.force_consts(ca, L, min_dist)
    ps = edge_gather(g, pos)                        # source endpoint per edge
    pd = pos[dst_clip]
    delta = pd - ps
    dist = torch.sqrt((delta * delta).sum(dim=1) + md2)
    tgt = ps + delta / dist[:, None] * ell[:, None]
    vec = torch.where(g.emask[:, None], we[:, None] * tgt, 0.0)
    num = segment_sum(vec, g.dst_l, n_pad + 1)[:n_pad]
    rep = gila.repulsion(g, pos, nbr_idx, nbr_mask, C=ca, L=L,
                         min_dist=min_dist, mode=mode, grid_dim=grid_dim,
                         cell_cap=cell_cap)
    new = (num + rep) / torch.clamp_min(rho, 1e-12)[:, None]
    new = torch.where(rho[:, None] > 0, new, pos)   # no edges → stay put
    d = new - pos
    norm = torch.sqrt((d * d).sum(dim=1) + 1e-12)
    step = torch.clamp(norm, max=temp)              # GiLA's cooling clamp
    pos = pos + d / norm[:, None] * step[:, None]
    return torch.where(g.vmask[:, None], pos, 0.0)


def stress_layout(g: PaddedGraph, pos0, nbr_idx, nbr_mask, *, mode: str,
                  iters: int, temp0: float, temp_decay: float,
                  alpha0: float, alpha_decay: float, ideal_len: float,
                  rep_const: float, min_dist: float = 1e-3,
                  grid_dim: int = 0, cell_cap: int = 0) -> torch.Tensor:
    """``iters`` maxent-stress iterations from ``pos0``, the
    ``gila.gila_layout`` analogue."""
    L, C = _build.f32(ideal_len), np.float32(rep_const)
    ell, we, rho = stress_terms(g, L)
    dst_clip = torch.clamp(g.dst_l, 0, g.n_pad - 1)
    pos = pos0
    for temp, alpha in zip(gila.temperatures(temp0, temp_decay, iters),
                           gila.temperatures(alpha0, alpha_decay, iters)):
        ca = float(np.float32(alpha) * C)           # α·C in float32
        pos = stress_iteration(g, pos, nbr_idx, nbr_mask, ell, we, rho,
                               dst_clip, temp, ca, L=L, min_dist=min_dist,
                               mode=mode, grid_dim=grid_dim,
                               cell_cap=cell_cap)
    return pos


class StressEngine(engine_mod.RefinementEngine):
    """Multilevel maxent-stress as a drop-in refinement engine."""

    name = "stress"
    sched_k = 4                 # (temp0, temp_decay, alpha0, alpha_decay)

    def lane_schedule(self, sched) -> tuple:
        a0, ad = alpha_schedule(sched.iters)
        return (sched.temp0, sched.temp_decay, a0, ad)

    def refine(self, g, pos0, nbr_idx, nbr_mask, sched, *, ideal_len,
               rep_const, min_dist=1e-3):
        temp0, temp_decay, a0, ad = self.lane_schedule(sched)
        return stress_layout(
            g, pos0, nbr_idx, nbr_mask, mode=sched.mode, iters=sched.iters,
            temp0=temp0, temp_decay=temp_decay, alpha0=a0, alpha_decay=ad,
            ideal_len=ideal_len, rep_const=rep_const, min_dist=min_dist,
            grid_dim=sched.grid_dim, cell_cap=sched.cell_cap)


engine_mod.register(StressEngine())
