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

Attraction is a plain ``index_add_`` over the half-edges. One iteration
(``layout_iteration``) reads every number it needs from device tensors: a
schedule row (temperature, C·L², md²) computed in float32 on the host, as
the JAX package anneals in float32, and the ideal length L. So one captured
CUDA graph of it serves every level, temperature and constant of its shape
bucket (``core/bucketing.py``); ``engine.RefinementEngine.refine`` runs
the same iteration in a Python loop.

The batched driver's groups run ``layout_iteration_many`` over ``[B,
n_pad]`` lanes: element for element the arithmetic of ``layout_iteration``
on each lane, with the edge sums taken without a scatter where the lanes'
degrees allow (``lane_segment_sum``), so that every lane gives the bits of
the same level refined alone on the CPU, and repeats its own bits on the
card.
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

def _attraction(g: PaddedGraph, pos, L, md2):
    """FR attraction along edges with per-edge desired length ℓ_e = w_e·L:
    f_a(d) = d² / ℓ_e, directed toward the neighbor. ``L`` and ``md2`` are
    float32 0-d tensors (or host floats: float32 arithmetic either way)."""
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


def repulsion(g: PaddedGraph, pos, nbr_idx, nbr_mask, consts, *, mode: str,
              grid_dim: int = 0, cell_cap: int = 0) -> torch.Tensor:
    """FR repulsion per vertex through the kernel of ``mode`` — GiLA's
    repulsion and the stress engine's entropy term (whose C is α·C).
    ``consts`` = float32[2] (C·L², md²) on pos's device: the kernels read it
    from device memory."""
    if mode == "exact":
        return nbody_repulsion(pos, g.mass, g.vmask, consts)
    if mode == "grid":
        return grid_repulsion(pos, g.mass, g.vmask, consts,
                              grid_dim=grid_dim, cell_cap=cell_cap)
    if mode == "neighbor":
        return neighbor_repulsion(pos, g.mass, nbr_idx, nbr_mask, g.vmask,
                                  consts)
    raise ValueError(f"unknown repulsion mode {mode!r}")


def layout_iteration(g: PaddedGraph, pos, nbr_idx, nbr_mask, row, L, *,
                     mode: str, grid_dim: int = 0, cell_cap: int = 0
                     ) -> torch.Tensor:
    """One GiLA iteration on tensors alone: forces + cooling displacement
    clamp. ``row`` = float32[3] (temperature, C·L², md²), one row of
    ``schedule_rows``; ``L`` the ideal length, a float32 0-d tensor."""
    rep = repulsion(g, pos, nbr_idx, nbr_mask, row[1:], mode=mode,
                    grid_dim=grid_dim, cell_cap=cell_cap)
    f = rep + _attraction(g, pos, L, row[2])
    norm = torch.sqrt((f * f).sum(dim=1) + 1e-12)
    step = torch.clamp(norm, max=row[0])
    pos = pos + f / norm[:, None] * step[:, None]
    return torch.where(g.vmask[:, None], pos, 0.0)


# -- lanes: the batched driver's [B, n_pad] groups ------------------------------

def lane_index(g: PaddedGraph, inc: torch.Tensor) -> tuple:
    """The flat index tensors of a lane graph (``g`` with [B, n_pad] and
    [B, m_pad] tensors, ``inc`` its int32[B, n_pad, k] incidence tables):
    lane b's vertex v lives at b·(n_pad+1) + v of one flat index space, with
    a zero sentinel row per lane at v = n_pad, and its half-edge slot e at
    b·(m_pad+1) + e. Returns int64 (flat_src [B, m_pad], flat_dst_clip
    [B, m_pad] (dst clamped to the lane's rows), flat_dst [B·m_pad],
    flat_inc [B, n_pad, k])."""
    B, n_pad = g.vmask.shape
    m_pad = g.src.shape[1]
    lane = torch.arange(B, dtype=torch.int64, device=g.device)[:, None]
    offs = lane * (n_pad + 1)
    flat_src = g.src.long() + offs
    flat_dst_clip = torch.clamp(g.dst.long(), 0, n_pad - 1) + offs
    flat_dst = (g.dst.long() + offs).reshape(-1)
    flat_inc = inc.long() + (lane * (m_pad + 1))[..., None]
    return flat_src, flat_dst_clip, flat_dst, flat_inc


def flat_positions(pos: torch.Tensor) -> torch.Tensor:
    """[B, n_pad, 2] → [B·(n_pad+1), 2] with a zero sentinel row per lane
    (the dense-array 'empty inbox'), for gathers through ``lane_index``."""
    B, n_pad = pos.shape[:2]
    return torch.cat([pos, pos.new_zeros((B, 1, 2))], dim=1).reshape(
        B * (n_pad + 1), 2)


def lane_segment_sum(x: torch.Tensor, flat_inc: torch.Tensor,
                     flat_dst: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Per-vertex sum of a per-edge quantity x [B, m_pad, ...] → [B, n_pad,
    ...], each vertex's messages added in ``segment_sum``'s order (ascending
    slot). With incidence tables (k = flat_inc.shape[2] > 0): k unrolled,
    left-associated gathered adds, no scatter and so no atomics on the card;
    hub-heavy groups (k = 0) take one flat ``segment_sum`` over the lanes'
    fused index space instead."""
    B, m_pad = x.shape[:2]
    rest = x.shape[2:]
    if flat_inc.shape[2] > 0:
        xf = torch.cat([x, x.new_zeros((B, 1) + rest)], dim=1).reshape(
            (B * (m_pad + 1),) + rest)
        acc = x.new_zeros((B, n_pad) + rest)
        for k in range(flat_inc.shape[2]):     # left-assoc: scatter order
            acc = acc + xf[flat_inc[:, :, k]]
        return acc
    out = segment_sum(x.reshape((B * m_pad,) + rest), flat_dst,
                      B * (n_pad + 1))
    return out.reshape((B, n_pad + 1) + rest)[:, :n_pad]


def _attraction_many(g: PaddedGraph, pos, terms, md2) -> torch.Tensor:
    """``_attraction`` over lanes: ``terms`` = ``lane_index`` + (ℓ [B,
    m_pad],), ``md2`` [B] per lane."""
    flat_src, flat_dst_clip, flat_dst, flat_inc, ell = terms
    flat = flat_positions(pos)
    delta = flat[flat_src] - flat[flat_dst_clip]    # pull dst toward src
    dist = torch.sqrt((delta * delta).sum(dim=-1) + md2[:, None])
    f = (dist * dist) / ell                         # FR: d²/ℓ
    vec = delta / dist[..., None] * f[..., None]
    vec = torch.where(g.emask[..., None], vec, 0.0)
    return lane_segment_sum(vec, flat_inc, flat_dst, pos.shape[1])


def layout_iteration_many(g: PaddedGraph, pos, nbr_idx, nbr_mask, terms,
                          row, *, mode: str, grid_dim: int = 0,
                          cell_cap: int = 0) -> torch.Tensor:
    """``layout_iteration`` on B lanes at once: ``g`` a lane graph, pos
    [B, n_pad, 2], ``row`` [B, 3] each lane's schedule row (temperature,
    C·L², md²), ``terms`` from ``GilaEngine.prepare_many``. The repulsion
    kernels take all lanes in one launch."""
    rep = repulsion(g, pos, nbr_idx, nbr_mask, row[:, 1:].contiguous(),
                    mode=mode, grid_dim=grid_dim, cell_cap=cell_cap)
    f = rep + _attraction_many(g, pos, terms, row[:, 2])
    norm = torch.sqrt((f * f).sum(dim=-1) + 1e-12)
    step = torch.minimum(norm, row[:, 0, None])
    pos = pos + f / norm[..., None] * step[..., None]
    return torch.where(g.vmask[..., None], pos, 0.0)


def temperatures(temp0: float, temp_decay: float, iters: int) -> list[float]:
    """The float32 cooling schedule: temp_i = temp_{i-1}·decay in float32
    (the stress engine anneals its α the same way)."""
    t, d = np.float32(temp0), np.float32(temp_decay)
    out = []
    for _ in range(iters):
        out.append(float(t))
        t = np.float32(t * d)
    return out


def schedule_rows(temps, rep_consts, ideal_len: float, min_dist: float
                  ) -> np.ndarray:
    """float32[iters, 3]: per iteration (temperature, C·L², md²) for the
    temperatures ``temps`` and repulsion constants ``rep_consts`` (one
    each), rounded on the host as ``_build.force_consts`` rounds them."""
    rows = np.empty((len(temps), 3), np.float32)
    for i, (t, c) in enumerate(zip(temps, rep_consts, strict=True)):
        rows[i] = (t, *_build.force_consts(c, ideal_len, min_dist))
    return rows


def random_init(g: PaddedGraph, scale: float, seed: int = 0) -> torch.Tensor:
    """Uniform initial positions in [-scale, scale)², drawn per vertex so a
    real vertex's draw does not depend on the padding."""
    ids = torch.arange(g.n_pad, dtype=torch.int32, device=g.device)
    pos = prng.uniform2_per_vertex(prng.prng_key(seed), ids,
                                   minval=-scale, maxval=scale)
    return torch.where(g.vmask[:, None], pos, 0.0)
