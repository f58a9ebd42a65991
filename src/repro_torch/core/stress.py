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
``alpha * C`` is; each iteration reads its temperature and α·C·L² from a
schedule row on the device, as GiLA's does.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import engine as engine_mod
from repro_torch.core import gila
from repro_torch.graphs.graph import PaddedGraph, edge_gather, segment_sum

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


def stress_terms(g: PaddedGraph, L):
    """Position-independent per-level terms, hoisted out of the iteration
    loop: target lengths ℓ_e, weights w_e = 1/ℓ_e² (0 on padding), the
    per-vertex weight sum ρ, and ``dst`` clamped to [0, n_pad). ``L`` is
    the ideal length, a float32 0-d tensor."""
    ell = torch.clamp_min(g.ewt, 1e-6) * L
    we = torch.where(g.emask, 1.0 / (ell * ell), 0.0)
    rho = segment_sum(we, g.dst_l, g.n_pad + 1)[:g.n_pad]
    return ell, we, rho, torch.clamp(g.dst_l, 0, g.n_pad - 1)


def stress_iteration(g: PaddedGraph, pos, nbr_idx, nbr_mask, terms, row, *,
                     mode: str, grid_dim: int = 0, cell_cap: int = 0
                     ) -> torch.Tensor:
    """One maxent-stress Jacobi iteration on tensors alone: ``terms`` from
    ``stress_terms``; ``row`` = float32[3] (temperature, α·C·L², md²), one
    row of ``StressEngine.schedule_rows``."""
    ell, we, rho, dst_clip = terms
    n_pad = g.n_pad
    ps = edge_gather(g, pos)                        # source endpoint per edge
    pd = pos[dst_clip]
    delta = pd - ps
    dist = torch.sqrt((delta * delta).sum(dim=1) + row[2])
    tgt = ps + delta / dist[:, None] * ell[:, None]
    vec = torch.where(g.emask[:, None], we[:, None] * tgt, 0.0)
    num = segment_sum(vec, g.dst_l, n_pad + 1)[:n_pad]
    rep = gila.repulsion(g, pos, nbr_idx, nbr_mask, row[1:], mode=mode,
                         grid_dim=grid_dim, cell_cap=cell_cap)
    new = (num + rep) / torch.clamp_min(rho, 1e-12)[:, None]
    new = torch.where(rho[:, None] > 0, new, pos)   # no edges → stay put
    d = new - pos
    norm = torch.sqrt((d * d).sum(dim=1) + 1e-12)
    step = torch.clamp(norm, max=row[0])            # GiLA's cooling clamp
    pos = pos + d / norm[:, None] * step[:, None]
    return torch.where(g.vmask[:, None], pos, 0.0)


def stress_terms_many(g: PaddedGraph, L, index) -> tuple:
    """``stress_terms`` over lanes: ``index`` = ``gila.lane_index`` of the
    lane graph; returns it + (ℓ, w, ρ), ρ summed in ``segment_sum``'s order
    (``gila.lane_segment_sum``)."""
    ell = torch.clamp_min(g.ewt, 1e-6) * L
    we = torch.where(g.emask, 1.0 / (ell * ell), 0.0)
    _, _, flat_dst, flat_inc = index
    rho = gila.lane_segment_sum(we, flat_inc, flat_dst, g.vmask.shape[1])
    return tuple(index) + (ell, we, rho)


def stress_iteration_many(g: PaddedGraph, pos, nbr_idx, nbr_mask, terms,
                          row, *, mode: str, grid_dim: int = 0,
                          cell_cap: int = 0) -> torch.Tensor:
    """``stress_iteration`` on B lanes at once: ``row`` [B, 3] each lane's
    (temperature, α·C·L², md²), so the kernels' entropy constants are per
    lane; ``terms`` from ``stress_terms_many``."""
    flat_src, flat_dst_clip, flat_dst, flat_inc, ell, we, rho = terms
    flat = gila.flat_positions(pos)
    ps = flat[flat_src]                             # source endpoint per edge
    pd = flat[flat_dst_clip]
    delta = pd - ps
    dist = torch.sqrt((delta * delta).sum(dim=-1) + row[:, 2, None])
    tgt = ps + delta / dist[..., None] * ell[..., None]
    vec = torch.where(g.emask[..., None], we[..., None] * tgt, 0.0)
    num = gila.lane_segment_sum(vec, flat_inc, flat_dst, pos.shape[1])
    rep = gila.repulsion(g, pos, nbr_idx, nbr_mask, row[:, 1:].contiguous(),
                         mode=mode, grid_dim=grid_dim, cell_cap=cell_cap)
    new = (num + rep) / torch.clamp_min(rho, 1e-12)[..., None]
    new = torch.where(rho[..., None] > 0, new, pos)  # no edges → stay put
    d = new - pos
    norm = torch.sqrt((d * d).sum(dim=-1) + 1e-12)
    step = torch.minimum(norm, row[:, 0, None])     # GiLA's cooling clamp
    pos = pos + d / norm[..., None] * step[..., None]
    return torch.where(g.vmask[..., None], pos, 0.0)


class StressEngine(engine_mod.RefinementEngine):
    """Multilevel maxent-stress as a drop-in refinement engine."""

    name = "stress"
    sched_k = 4                 # (temp0, temp_decay, alpha0, alpha_decay)

    def lane_schedule(self, sched) -> tuple:
        a0, ad = alpha_schedule(sched.iters)
        return (sched.temp0, sched.temp_decay, a0, ad)

    def schedule_rows(self, sched, *, ideal_len, rep_const, min_dist=1e-3):
        """Row i: (temp_i, (α_i·C)·L², md²), α_i·C rounded to float32 as
        the JAX package's traced ``alpha * C`` is."""
        temp0, temp_decay, a0, ad = self.lane_schedule(sched)
        C = np.float32(rep_const)
        cas = [float(np.float32(a) * C)
               for a in gila.temperatures(a0, ad, sched.iters)]
        return gila.schedule_rows(
            gila.temperatures(temp0, temp_decay, sched.iters), cas,
            ideal_len, min_dist)

    def prepare(self, g, params):
        return stress_terms(g, params[1])

    def step(self, g, pos, nbr_idx, nbr_mask, terms, row, params, *, mode,
             grid_dim=0, cell_cap=0):
        return stress_iteration(g, pos, nbr_idx, nbr_mask, terms, row,
                                mode=mode, grid_dim=grid_dim,
                                cell_cap=cell_cap)

    def prepare_many(self, g, inc, params):
        return stress_terms_many(g, params[1], gila.lane_index(g, inc))

    def step_many(self, g, pos, nbr_idx, nbr_mask, terms, row, params, *,
                  mode, grid_dim=0, cell_cap=0):
        return stress_iteration_many(g, pos, nbr_idx, nbr_mask, terms, row,
                                     mode=mode, grid_dim=grid_dim,
                                     cell_cap=cell_cap)


engine_mod.register(StressEngine())
