"""Grid-bucketed approximate repulsion — binning, composition, and the
wrappers of the near and far CUDA kernels (csrc/grid_near.cu,
csrc/grid_far.cu).

``grid_repulsion`` is the op the layout engine calls (mode="grid" in
core/gila.py), the JAX package's ``grid_force/ops.py`` on torch tensors.
Per call (positions move every iteration, so all of it reruns):

  1. *Bin*: bounding box of the valid vertices → uniform ``G×G`` grid;
     each vertex gets a cell id. A stable sort + searchsorted assigns a
     within-cell rank; vertices with rank < ``cell_cap`` land in a dense
     bucket table [G²+1, cap] (sentinel row/slots = n).
  2. *Near field* (exact): every bucketed vertex vs the buckets of its
     3×3 cell neighborhood — ``grid_near``.
  3. *Far field* (approximate): every vertex vs the aggregates (total mass
     at centroid) of ALL cells — ``grid_far`` — plus ``far_corrections``:
     minus the 9 near cells' aggregates, plus the Plummer-softened
     aggregates of near-cell overflow vertices, and for overflow vertices
     the softened in-bucket aggregates of their 9 cells.

Each wrapper runs its plain version (ref.py) for a CPU tensor and launches
its kernel, or raises, for a CUDA tensor.
"""
from __future__ import annotations

import functools
import math

import torch

from repro_torch.graphs.graph import segment_sum
from repro_torch.kernels import _build
from repro_torch.kernels.grid_force.ref import grid_near_ref, grid_far_ref

_EPS = 1e-12
_AVG_OCCUPANCY = 12      # target vertices per grid cell


def choose_grid(n: int) -> tuple[int, int]:
    """Static (grid_dim, cell_cap) for an n-vertex level: ~``_AVG_OCCUPANCY``
    vertices per cell, a cap of the mean plus ~6σ of a Poisson cell load."""
    n = max(int(n), 1)
    G = int(round(math.sqrt(n / _AVG_OCCUPANCY)))
    G = max(2, min(G, 128))
    avg = n / (G * G)
    cap = int(math.ceil(avg + 6.0 * math.sqrt(avg) + 8.0))
    cap = min(max(8, (cap + 7) // 8 * 8), n)
    return G, max(cap, 1)


def grid_cell_size(lo: torch.Tensor, hi: torch.Tensor, grid_dim: int):
    """Canonical G×G cell size over box (lo, hi): ``max(hi-lo, 1e-6)/G``
    in float32."""
    return torch.clamp_min(hi - lo, 1e-6) / float(grid_dim)


@functools.lru_cache(maxsize=16)
def neighbor_table(G: int, device: torch.device) -> torch.Tensor:
    """int32[G²+1, 9] cell ids of each cell's 3×3 neighborhood (incl.
    itself); out-of-range neighbors and the sentinel row point at G².
    Cached per (G, device), since every grid iteration of a level needs it:
    callers share the tensor and must not write to it."""
    nc = G * G
    cells = torch.arange(nc, device=device)
    cx, cy = cells % G, cells // G
    cols = []
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            nx, ny = cx + ox, cy + oy
            ok = (0 <= nx) & (nx < G) & (0 <= ny) & (ny < G)
            cols.append(torch.where(ok, ny * G + nx, nc))
    table = torch.stack(cols, dim=1).to(torch.int32)
    return torch.cat([table, torch.full((1, 9), nc, dtype=torch.int32,
                                        device=device)])


def _box(pos, vmask):
    big = 3e38
    lo = torch.where(vmask[:, None], pos, big).amin(dim=0)
    hi = torch.where(vmask[:, None], pos, -big).amax(dim=0)
    return lo, hi


def bin_vertices(pos, vmask, grid_dim: int, cell_cap: int):
    """Bucket vertices into a G×G grid over their bounding box.

    Returns (cid[n] int32 with sentinel G², bucket[G²+1, cap] int32 with
    sentinel n, inb[n] bool — vertex made it into its cell's bucket).
    Bucket slot order is the vertices' array order (the sort is stable), so
    the table is bit-identical to the JAX package's for the same positions.
    """
    n = pos.shape[0]
    G, cap = grid_dim, cell_cap
    nc = G * G
    lo, hi = _box(pos, vmask)
    cell = grid_cell_size(lo, hi, G)
    ij = torch.clamp(torch.floor((pos - lo) / cell), 0, G - 1).to(torch.int32)
    cid = torch.where(vmask, ij[:, 1] * G + ij[:, 0], nc).to(torch.int32)

    sc, order = torch.sort(cid, stable=True)
    rank = (torch.arange(n, device=pos.device)
            - torch.searchsorted(sc, sc, side="left"))
    ok = (rank < cap) & (sc < nc)
    bucket = torch.full((nc + 1, cap), n, dtype=torch.int32,
                        device=pos.device)
    bucket[torch.where(ok, sc, nc).long(), torch.where(ok, rank, 0)] = \
        torch.where(ok, order.to(torch.int32), n)
    inb = torch.zeros(n, dtype=torch.bool, device=pos.device)
    inb[order] = ok
    return cid, bucket, inb


def _cell_aggregates(pos, w, cid_l, nc: int):
    """(mass[nc+1], weighted-sum[nc+1, 2], centroid[nc+1, 2]) per cell."""
    M = segment_sum(w, cid_l, nc + 1)
    S = segment_sum(w[:, None] * pos, cid_l, nc + 1)
    return M, S, S / torch.clamp_min(M, _EPS)[:, None]


def cell_centers(pos, vmask, grid_dim: int):
    """Geometric centers of the G×G cells over the vertices' bounding box:
    [G²+1, 2] (sentinel row = 0)."""
    G = grid_dim
    lo, hi = _box(pos, vmask)
    cell = grid_cell_size(lo, hi, G)
    ids = torch.arange(G * G, device=pos.device)
    xy = torch.stack([ids % G, ids // G], dim=1).to(torch.float32)
    ctr = lo[None, :] + (xy + 0.5) * cell[None, :]
    return torch.cat([ctr, ctr.new_zeros((1, 2))])


def _rms(Q, M, S, centers):
    """Per-cell RMS radius from mass M, weighted-position sum S and the
    second moment Q accumulated about ``centers``."""
    mu_rel = S / torch.clamp_min(M, _EPS)[:, None] - centers
    return torch.sqrt(torch.clamp_min(
        Q / torch.clamp_min(M, _EPS) - (mu_rel * mu_rel).sum(dim=1), 0.0))


def _agg_field_9(pos, mu9, m9, cl2: float, md2: float, r9=None):
    """Aggregate force field of each vertex's 9 gathered cells:
    pos [n, 2], mu9 [n, 9, 2], m9 [n, 9] → [n, 2], optionally
    Plummer-softened by the cells' RMS radii ``r9``."""
    dx = pos[:, 0:1] - mu9[..., 0]
    dy = pos[:, 1:2] - mu9[..., 1]
    d2 = dx * dx + dy * dy + md2
    if r9 is not None:
        d2 = d2 + r9 * r9
    inv = (cl2 * m9) / d2
    return torch.stack([(dx * inv).sum(dim=1), (dy * inv).sum(dim=1)], dim=1)


def far_corrections(pos, w_out, cid_l, inb, M_full, S_full, Q_full,
                    M_out, S_out, Q_out, cl2: float, md2: float, *,
                    table, centers):
    """The force to ADD to the all-cells aggregate term: minus the 9 near
    cells' full aggregates (counted exactly by the near field), plus the
    softened overflow aggregates (minus the vertex's own mass in its own
    cell), plus — for overflow vertices only — the softened in-bucket
    aggregates of their 9 cells."""
    mu_full = S_full / torch.clamp_min(M_full, _EPS)[:, None]
    mu_out = S_out / torch.clamp_min(M_out, _EPS)[:, None]
    r_out = _rms(Q_out, M_out, S_out, centers)
    M_in = M_full - M_out
    S_in = S_full - S_out
    mu_in = S_in / torch.clamp_min(M_in, _EPS)[:, None]
    r_in = _rms(Q_full - Q_out, M_in, S_in, centers)

    near9 = table.long()[cid_l]                                 # [n, 9]
    f = -_agg_field_9(pos, mu_full[near9], M_full[near9], cl2, md2)
    m9 = M_out[near9].clone()
    mu9 = mu_out[near9].clone()
    m_adj = torch.clamp_min(M_out[cid_l] - w_out, 0.0)
    s_adj = S_out[cid_l] - w_out[:, None] * pos
    m9[:, 4] = m_adj
    mu9[:, 4] = s_adj / torch.clamp_min(m_adj, _EPS)[:, None]
    f = f + _agg_field_9(pos, mu9, m9, cl2, md2, r9=r_out[near9])
    f_bkt = _agg_field_9(pos, mu_in[near9], M_in[near9], cl2, md2,
                         r9=r_in[near9])
    return f + torch.where(inb, 0.0, 1.0)[:, None] * f_bkt


def grid_near(pos, mass, vmask, bucket, table, C, L, min_dist
              ) -> torch.Tensor:
    """Exact 3×3 near field → f_near f32[n, 2] (0 for unbucketed vertices).
    pos f32[n, 2]; mass f32[n]; vmask bool[n]; bucket int32[nc+1, cap]
    (sentinel n); table int32[nc+1, 9] (sentinel nc)."""
    cl2, md2 = _build.force_consts(C, L, min_dist)
    if pos.device.type == "cpu":
        return grid_near_ref(pos, mass, vmask, bucket, table, cl2, md2)
    if pos.device.type != "cuda":
        raise ValueError(f"grid_near: unsupported device {pos.device}")
    n, dev = pos.shape[0], pos.device
    nc, cap = bucket.shape[0] - 1, int(bucket.shape[1])
    _build.require(pos, "pos", torch.float32, (n, 2), dev)
    _build.require(mass, "mass", torch.float32, (n,), dev)
    _build.require(vmask, "vmask", torch.bool, (n,), dev)
    _build.require(bucket, "bucket", torch.int32, (nc + 1, cap), dev)
    _build.require(table, "table", torch.int32, (nc + 1, 9), dev)
    f_near = torch.zeros((n, 2), dtype=torch.float32, device=dev)
    err = _build.load().grid_near_launch(
        pos.data_ptr(), mass.data_ptr(), vmask.data_ptr(), bucket.data_ptr(),
        table.data_ptr(), n, nc, cap, cl2, md2, f_near.data_ptr(),
        _build.stream_of(pos))
    _build.launches["grid_near"] += 1
    _build.check(err, "grid_near")
    return f_near


def grid_far(pos, cell_xyw, C, L, min_dist) -> torch.Tensor:
    """Every vertex against every cell aggregate: pos f32[n, 2],
    cell_xyw f32[nc, 3] (x, y, mass) → f32[n, 2]."""
    cl2, md2 = _build.force_consts(C, L, min_dist)
    if pos.device.type == "cpu":
        return grid_far_ref(pos, cell_xyw, cl2, md2)
    if pos.device.type != "cuda":
        raise ValueError(f"grid_far: unsupported device {pos.device}")
    n, nc, dev = pos.shape[0], cell_xyw.shape[0], pos.device
    _build.require(pos, "pos", torch.float32, (n, 2), dev)
    _build.require(cell_xyw, "cell_xyw", torch.float32, (nc, 3), dev)
    if pos.data_ptr() % 8:
        raise ValueError("grid_far: pos must be 8-byte aligned (float2 loads)")
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    err = _build.load().grid_far_launch(
        pos.data_ptr(), n, cell_xyw.data_ptr(), nc, cl2, md2, out.data_ptr(),
        _build.stream_of(pos))
    _build.launches["grid_far"] += 1
    _build.check(err, "grid_far")
    return out


def grid_repulsion(pos, mass, vmask, C, L, min_dist, *,
                   grid_dim: int, cell_cap: int) -> torch.Tensor:
    """Grid-approximated FR repulsion: pos f32[n, 2] → forces f32[n, 2]."""
    if grid_dim < 2 or cell_cap < 1:
        raise ValueError(f"grid_dim={grid_dim}, cell_cap={cell_cap}")
    G, cap = grid_dim, cell_cap
    nc = G * G
    cl2, md2 = _build.force_consts(C, L, min_dist)
    w = torch.where(vmask, mass, 0.0)

    cid, bucket, inb = bin_vertices(pos, vmask, G, cap)
    cid_l = cid.long()
    M_full, S_full, mu_full = _cell_aggregates(pos, w, cid_l, nc)
    w_out = torch.where(inb, 0.0, w)
    M_out, S_out, _ = _cell_aggregates(pos, w_out, cid_l, nc)
    centers = cell_centers(pos, vmask, G)
    rel = pos - centers[cid_l]
    q = (rel * rel).sum(dim=1)
    Q_full = segment_sum(w * q, cid_l, nc + 1)
    Q_out = segment_sum(w_out * q, cid_l, nc + 1)

    table = neighbor_table(G, pos.device)
    f_near = grid_near(pos, mass, vmask, bucket, table, C, L, min_dist)
    cell_xyw = torch.cat([mu_full[:nc], M_full[:nc, None]], dim=1)
    f_far = grid_far(pos, cell_xyw, C, L, min_dist)
    f_far = f_far + far_corrections(pos, w_out, cid_l, inb, M_full, S_full,
                                    Q_full, M_out, S_out, Q_out, cl2, md2,
                                    table=table, centers=centers)
    return torch.where(vmask[:, None], f_near + f_far, 0.0)
