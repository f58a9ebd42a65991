"""Distributed Solar Placer — the placement phase of Multi-GiLA (paper §3.3).

Level-(i+1) positions flow back to the level-i suns through the inter-level
edges; every planet/moon on an inter-system path is placed at the
barycentric point between its own sun and the neighboring system's sun
(fraction = its depth over the path length); members with no inter-system
link scatter around their sun at a radius proportional to their depth.
The JAX package's ``core/solar_placer.py`` on torch tensors.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.solar_merger import SUN, LevelInfo
from repro_torch.graphs.graph import PaddedGraph, edge_gather, segment_sum
from repro_torch.utils import prng


def _place(g: PaddedGraph, sun_of, depth, sun_pos, key,
           scatter_scale: float) -> torch.Tensor:
    """sun_pos: float32[n_pad, 2] — position of each vertex's SUN. Returns
    positions for all vertices."""
    n_pad = g.n_pad
    dst_ok = g.dst < n_pad
    dst_c = torch.clamp(g.dst_l, 0, n_pad - 1)
    sun_src = edge_gather(g, sun_of)
    depth_src = edge_gather(g, depth)
    sun_dst = torch.where(dst_ok, sun_of[dst_c], n_pad)
    depth_dst = torch.where(dst_ok, depth[dst_c], 0)
    cross = (g.emask & (sun_src != sun_dst) & (sun_src < n_pad)
             & (sun_dst < n_pad))

    pos_sun_dst = sun_pos[dst_c]
    pos_sun_src = edge_gather(g, sun_pos)
    plen = (depth_src + 1 + depth_dst).to(torch.float32)
    frac = depth_dst.to(torch.float32) / torch.clamp_min(plen, 1.0)
    suggestion = (pos_sun_dst * (1.0 - frac[:, None])
                  + pos_sun_src * frac[:, None])
    suggestion = torch.where(cross[:, None], suggestion, 0.0)
    cnt = segment_sum(cross.to(torch.float32), g.dst_l, n_pad + 1)[:n_pad]
    acc = segment_sum(suggestion, g.dst_l, n_pad + 1)[:n_pad]

    mean_sugg = acc / torch.clamp_min(cnt, 1.0)[:, None]
    ids = torch.arange(n_pad, dtype=torch.int32, device=g.device)
    ang = prng.uniform_per_vertex(key, ids, minval=0.0, maxval=2 * math.pi)
    offs = torch.stack([torch.cos(ang), torch.sin(ang)], dim=1)
    radius = scatter_scale * torch.clamp_min(depth, 1).to(torch.float32)
    scatter = sun_pos + offs * radius[:, None]
    return torch.where((cnt > 0)[:, None], mean_sugg, scatter)


def solar_placer(g: PaddedGraph, info: LevelInfo, coarse_pos: torch.Tensor,
                 *, scatter_scale: float = 0.5, seed: int = 0) -> torch.Tensor:
    """Initial level-i positions from the coarse drawing Γ_{i+1}."""
    coarse_pos = coarse_pos.to(device=g.device, dtype=torch.float32)
    pc = torch.clamp_min(info.parent_coarse, 0).long()
    member_sun_pos = coarse_pos[pc]                    # [n_pad, 2]
    depth = torch.clamp_min(info.depth, 0)
    scale = float(torch.tensor(scatter_scale, dtype=torch.float32))
    pos = _place(g, info.sun_of, depth, member_sun_pos,
                 prng.prng_key(seed), scale)
    is_sun = (info.state == SUN) & g.vmask
    # suns sit exactly at their coarse position
    return torch.where(is_sun[:, None], member_sun_pos, pos)
