"""Plain PyTorch version of the all-pairs FR repulsion kernel.

Force on v:  f_v = Σ_u C · L² · w_u · (pos_v − pos_u) / (|pos_v − pos_u|² + md²)
with w_u = mass_u · vmask_u; rows outside vmask get 0. ``cl2 = C·L·L`` and
``md2 = md·md`` arrive rounded as float32 arithmetic rounds them
(``kernels._build.force_consts``). Row-chunked, so peak memory stays
O(chunk · n) at any n.
"""
from __future__ import annotations

import torch


def two_set_ref(tpos, spos, sw, cl2: float, md2: float, *,
                chunk_elems: int = 1 << 24) -> torch.Tensor:
    """Every target [nt, 2] against every source [ns, 2] of weight sw [ns]
    → [nt, 2]: the arithmetic of the nbody and grid_far kernels."""
    nt, ns = tpos.shape[0], spos.shape[0]
    cw = cl2 * sw
    out = tpos.new_empty((nt, 2))
    step = max(1, chunk_elems // max(ns, 1))
    for i in range(0, nt, step):
        rows = tpos[i:i + step]
        dx = rows[:, 0:1] - spos[None, :, 0]
        dy = rows[:, 1:2] - spos[None, :, 1]
        d2 = dx * dx + dy * dy + md2
        inv = cw[None, :] / d2
        out[i:i + step, 0] = (dx * inv).sum(dim=1)
        out[i:i + step, 1] = (dy * inv).sum(dim=1)
    return out


def nbody_repulsion_ref(pos, mass, vmask, cl2: float, md2: float):
    w = torch.where(vmask, mass, 0.0)
    f = two_set_ref(pos, pos, w, cl2, md2)
    return torch.where(vmask[:, None], f, 0.0)


def nbody_repulsion_lanes_ref(pos, mass, vmask, consts):
    """B independent lanes: pos [B, n, 2], mass [B, n], vmask [B, n],
    consts [B, 2] = (C·L², md²) of each lane → [B, n, 2]; lane b is
    ``nbody_repulsion_ref`` of lane b alone."""
    return torch.stack([nbody_repulsion_ref(pos[b], mass[b], vmask[b],
                                            consts[b, 0], consts[b, 1])
                        for b in range(pos.shape[0])])
