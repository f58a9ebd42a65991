"""GiLA — the single-level distributed force-directed refinement (paper §3.4).

Fruchterman–Reingold forces where the repulsive term of vertex v is
restricted to its k-hop neighborhood (the paper's locality principle), the
JAX package's ``core/gila.py`` on torch tensors. Three realizations of the
repulsion, picked per level by the schedule:

  * ``exact``    — all-pairs n-body (kernels/nbody);
  * ``neighbor`` — padded k-hop neighbor lists built once per level on the
                   host (kernels/neighbor_force);
  * ``grid``     — grid-bucketed approximate repulsion, rebinned every
                   iteration (kernels/grid_force).

Attraction is a plain ``index_add_`` over the half-edges. The iteration loop
runs in Python; the per-iteration temperatures are float32 on the host, as
the JAX package anneals them in float32.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.graph import (PaddedGraph, edge_gather, segment_sum,
                                      to_csr, unique_edges)
from repro_torch.kernels import _build
from repro_torch.kernels.grid_force.ops import grid_repulsion
from repro_torch.kernels.nbody.ops import nbody_repulsion
from repro_torch.kernels.neighbor_force.ops import neighbor_repulsion
from repro_torch.utils import prng


# -- k-hop neighbor lists (controlled flooding, topology-only) ----------------

def khop_neighbors(edges: np.ndarray, n: int, k: int, cap: int,
                   seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Padded k-hop neighbor lists via iterated expansion with random
    subsampling above ``cap`` (GiLA's flooding with bounded message load).

    Vectorized over (vertex, neighbor) pair arrays: per round the frontier
    pairs expand to their CSR neighborhoods, candidates are deduplicated
    against the accumulated sets through sorted ``v·(n+1)+u`` keys, and each
    vertex admits a uniform random sample of its remaining room. Host numpy
    with ``default_rng(seed)``, the JAX package's own code: the lists are
    identical to its lists. Each vertex's list is in ascending id order.

    Returns (idx[n, cap] int32 with sentinel n, mask[n, cap] bool).
    """
    rng = np.random.default_rng(seed)
    row_ptr, col = to_csr(edges, n)
    deg = np.diff(row_ptr).astype(np.int64)
    col = col.astype(np.int64)
    base = n + 1                      # (v, u) pair → unique int64 key

    def per_vertex_sample(v, u, room_of):
        """Keep a uniform random sample of ≤ room_of[v] pairs per vertex
        (rank candidates by random priority within each vertex group)."""
        pri = rng.random(v.size)
        order = np.lexsort((pri, v))
        sv, su = v[order], u[order]
        rank = np.arange(sv.size) - np.searchsorted(sv, sv, side="left")
        keep = rank < room_of[sv]
        return sv[keep], su[keep]

    # hop 1: the CSR pairs themselves, subsampled to cap where deg > cap
    src_v = np.repeat(np.arange(n, dtype=np.int64), deg)
    cv, cu = per_vertex_sample(src_v, col, np.full(n, cap, np.int64))
    counts = np.bincount(cv, minlength=n)
    cur_keys = np.sort(cv * base + cu)
    fv, fu = cv, cu                   # frontier: last round's additions

    for _ in range(k - 1):
        room_of = cap - counts
        act = room_of[fv] > 0 if fv.size else np.zeros(0, bool)
        fv, fu = fv[act], fu[act]
        if fv.size == 0:
            break
        # expand each frontier pair (v, u) to u's whole neighborhood
        d_u = deg[fu]
        tot = int(d_u.sum())
        if tot == 0:
            break
        ev = np.repeat(fv, d_u)
        idx_ = (np.repeat(row_ptr[fu], d_u)
                + (np.arange(tot) - np.repeat(np.cumsum(d_u) - d_u, d_u)))
        ew = col[idx_]
        ok = ev != ew
        keys = np.unique(ev[ok] * base + ew[ok])          # dedup candidates
        # drop pairs already collected (cur_keys is sorted + unique)
        pos = np.searchsorted(cur_keys, keys)
        pos = np.minimum(pos, max(cur_keys.size - 1, 0))
        fresh = (keys != cur_keys[pos]) if cur_keys.size else \
            np.ones(keys.size, bool)
        keys = keys[fresh]
        if keys.size == 0:
            break
        av, au = per_vertex_sample(keys // base, keys % base, room_of)
        counts = counts + np.bincount(av, minlength=n)
        cur_keys = np.sort(np.concatenate([cur_keys, av * base + au]))
        fv, fu = av, au

    allv, allu = cur_keys // base, cur_keys % base        # sorted by (v, u)
    rank = np.arange(allv.size) - np.searchsorted(allv, allv, side="left")
    idx = np.full((n, cap), n, dtype=np.int32)
    mask = np.zeros((n, cap), dtype=bool)
    idx[allv, rank] = allu
    mask[allv, rank] = True
    return idx, mask


def pad_neighbors(idx: np.ndarray, mask: np.ndarray, n_pad: int, *,
                  device) -> tuple[torch.Tensor, torch.Tensor]:
    """Pad [n,cap] lists up to [n_pad,cap] with sentinel n_pad."""
    n, cap = idx.shape
    out = np.full((n_pad, cap), n_pad, dtype=np.int32)
    out[:n] = np.where(mask, idx, n_pad)
    om = np.zeros((n_pad, cap), dtype=bool)
    om[:n] = mask
    return (torch.from_numpy(out).to(device),
            torch.from_numpy(om).to(device))


def build_level_neighbors(g: PaddedGraph, k: int, cap: int, seed: int = 0
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """Host-side k-hop list construction for a padded graph."""
    idx, mask = khop_neighbors(unique_edges(g), g.n, k, cap, seed)
    return pad_neighbors(idx, mask, g.n_pad, device=g.device)


# -- forces -------------------------------------------------------------------

def _attraction(g: PaddedGraph, pos, L: float, md2: float):
    """FR attraction along edges with per-edge desired length ℓ_e = w_e·L:
    f_a(d) = d² / ℓ_e, directed toward the neighbor."""
    n_pad = g.n_pad
    pos_src = edge_gather(g, pos)
    pos_dst = pos[torch.clamp(g.dst_l, 0, n_pad - 1)]
    delta = pos_src - pos_dst                       # pull dst toward src
    dist = torch.sqrt((delta * delta).sum(dim=1) + md2)
    ell = torch.clamp_min(g.ewt, 1e-6) * L
    f = (dist * dist) / ell                         # FR: d²/ℓ
    vec = delta / dist[:, None] * f[:, None]
    vec = torch.where(g.emask[:, None], vec, 0.0)
    return segment_sum(vec, g.dst_l, n_pad + 1)[:n_pad]


def gila_forces(g: PaddedGraph, pos, nbr_idx, nbr_mask, *, C: float,
                L: float, min_dist: float, mode: str = "neighbor",
                grid_dim: int = 0, cell_cap: int = 0) -> torch.Tensor:
    """Total force per vertex: repulsion of ``mode`` plus attraction."""
    if mode == "exact":
        rep = nbody_repulsion(pos, g.mass, g.vmask, C, L, min_dist)
    elif mode == "grid":
        rep = grid_repulsion(pos, g.mass, g.vmask, C, L, min_dist,
                             grid_dim=grid_dim, cell_cap=cell_cap)
    elif mode == "neighbor":
        rep = neighbor_repulsion(pos, g.mass, nbr_idx, nbr_mask, g.vmask,
                                 C, L, min_dist)
    else:
        raise ValueError(f"unknown repulsion mode {mode!r}")
    _, md2 = _build.force_consts(C, L, min_dist)
    return rep + _attraction(g, pos, _build.f32(L), md2)


def layout_iteration(g: PaddedGraph, pos, nbr_idx, nbr_mask, temp: float, *,
                     C: float, L: float, min_dist: float, mode: str,
                     grid_dim: int = 0, cell_cap: int = 0) -> torch.Tensor:
    """One GiLA iteration: forces + cooling displacement clamp."""
    f = gila_forces(g, pos, nbr_idx, nbr_mask, C=C, L=L, min_dist=min_dist,
                    mode=mode, grid_dim=grid_dim, cell_cap=cell_cap)
    norm = torch.sqrt((f * f).sum(dim=1) + 1e-12)
    step = torch.clamp(norm, max=temp)
    pos = pos + f / norm[:, None] * step[:, None]
    return torch.where(g.vmask[:, None], pos, 0.0)


def temperatures(temp0: float, temp_decay: float, iters: int) -> list[float]:
    """The float32 cooling schedule: temp_i = temp_{i-1}·decay in float32."""
    t, d = np.float32(temp0), np.float32(temp_decay)
    out = []
    for _ in range(iters):
        out.append(float(t))
        t = np.float32(t * d)
    return out


def gila_layout(g: PaddedGraph, pos0, nbr_idx, nbr_mask, *, mode: str,
                iters: int, temp0: float, temp_decay: float,
                ideal_len: float, rep_const: float, min_dist: float = 1e-3,
                grid_dim: int = 0, cell_cap: int = 0) -> torch.Tensor:
    """Run ``iters`` force iterations with a cooling displacement clamp.
    In ``mode="grid"`` vertices are rebinned on every iteration."""
    pos = pos0
    for temp in temperatures(temp0, temp_decay, iters):
        pos = layout_iteration(g, pos, nbr_idx, nbr_mask, temp,
                               C=rep_const, L=ideal_len, min_dist=min_dist,
                               mode=mode, grid_dim=grid_dim,
                               cell_cap=cell_cap)
    return pos


def random_init(g: PaddedGraph, scale: float, seed: int = 0) -> torch.Tensor:
    """Uniform initial positions in [-scale, scale)², drawn per vertex so a
    real vertex's draw does not depend on the padding."""
    ids = torch.arange(g.n_pad, dtype=torch.int32, device=g.device)
    pos = prng.uniform2_per_vertex(prng.prng_key(seed), ids,
                                   minval=-scale, maxval=scale)
    return torch.where(g.vmask[:, None], pos, 0.0)
