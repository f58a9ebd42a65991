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

``near_field`` is the near field a row at a time (csrc/near_field.cu), the
form in which the sharded grid step (core/distributed.py) resolves it.
Each wrapper runs its plain version (ref.py) for a CPU tensor and launches
its kernel, or raises, for a CUDA tensor.

Lanes: every function here also takes B independent levels at once, each
array with a leading lane axis (pos [B, n_pad, 2], consts [B, 2], ...), as
the batched driver's groups hand them over (one ``grid_dim``/``cell_cap`` a
group, so the neighbor table is shared). Binning stays per lane: one stable
sort on ``lane·(nc+1) + cid`` gives each lane the cells, slots and
in-bucket flags of the lane alone; the cell aggregates sum over one flat
index space of ``B·(nc+1)`` cells, lane b's cell c at ``b·(nc+1) + c``; each
kernel takes all lanes in one launch. A single level is the one-lane case.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from repro_torch.graphs.graph import segment_sum
from repro_torch.kernels import _build
from repro_torch.kernels.grid_force.ref import (grid_far_lanes_ref,
                                                grid_near_lanes_ref,
                                                near_field_ref)

_EPS = 1e-12
_AVG_OCCUPANCY = 12      # target vertices per grid cell


def choose_grid(n: int, *, multiple_of: int = 1) -> tuple[int, int]:
    """Static (grid_dim, cell_cap) for an n-vertex level: ~``_AVG_OCCUPANCY``
    vertices per cell, a cap of the mean plus ~6σ of a Poisson cell load.
    ``multiple_of`` rounds grid_dim down to a multiple: the sharded halo
    variant bands the grid rows over the vertex ranks and needs
    grid_dim % ranks == 0 (core/distributed.py)."""
    n = max(int(n), 1)
    G = int(round(math.sqrt(n / _AVG_OCCUPANCY)))
    G = max(2, min(G, 128))
    if multiple_of > 1:
        G = max(multiple_of, G // multiple_of * multiple_of)
    avg = n / (G * G)
    cap = int(math.ceil(avg + 6.0 * math.sqrt(avg) + 8.0))
    cap = min(max(8, (cap + 7) // 8 * 8), n)
    return G, max(cap, 1)


def grid_cell_size(lo, hi, grid_dim: int):
    """Canonical G×G cell size over box (lo, hi): ``max(hi-lo, 1e-6)/G``
    in float32, on torch tensors or numpy arrays alike (the same bits).
    Every consumer that must agree bit for bit on which cell or tile a point
    lands in (``bin_vertices``, the serving layer's tile binning and
    viewport cover, serve/tiles.py and serve/query.py) derives the cell
    size here."""
    if isinstance(lo, torch.Tensor):
        return torch.clamp_min(hi - lo, 1e-6) / float(grid_dim)
    lo, hi = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
    return np.maximum(hi - lo, np.float32(1e-6)) / np.float32(grid_dim)


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
    """(lo, hi) of the valid vertices' bounding box: [2] each, or [B, 2]
    for lanes pos [B, n, 2]."""
    big = 3e38
    lo = torch.where(vmask[..., None], pos, big).amin(dim=-2)
    hi = torch.where(vmask[..., None], pos, -big).amax(dim=-2)
    return lo, hi


def _lane_offsets(B: int, stride: int, device) -> torch.Tensor:
    """int32[B, 1]: lane b's first slot, b·stride, in a flat index space."""
    return (torch.arange(B, dtype=torch.int32, device=device)
            * stride)[:, None]


def bin_vertices(pos, vmask, grid_dim: int, cell_cap: int, *, box=None):
    """Bucket vertices into a G×G grid over their bounding box.

    Returns (cid[n] int32 with sentinel G², bucket[G²+1, cap] int32 with
    sentinel n, inb[n] bool — vertex made it into its cell's bucket).
    Bucket slot order is the vertices' array order (the sort is stable), so
    the table is bit-identical to the JAX package's for the same positions;
    the serving tile pyramid (serve/tiles.py) turns the slots into a top-k
    by presenting vertices in descending mass order.
    Lanes pos [B, n, 2], vmask [B, n] give cid [B, n], bucket [B, G²+1,
    cap] (local ids) and inb [B, n]: each lane's the bits of the lane alone.

    ``box`` optionally fixes the binning box to ``(lo, hi)``, float32 [2]
    tensors on pos's device, instead of the vertices' own bounding box: the
    tile pyramid bins every zoom band against one global box so that tile
    keys align across bands. One box serves every lane.
    """
    if pos.dim() == 2:
        cid, bucket, inb = bin_vertices(pos[None], vmask[None], grid_dim,
                                        cell_cap, box=box)
        return cid[0], bucket[0], inb[0]
    B, n = vmask.shape
    dev = pos.device
    G, cap = grid_dim, cell_cap
    nc = G * G
    if box is None:
        lo, hi = _box(pos, vmask)
    else:
        lo, hi = (torch.as_tensor(b, dtype=torch.float32, device=dev)
                  .reshape(2).expand(B, 2) for b in box)
    cell = grid_cell_size(lo, hi, G)
    ij = torch.clamp(torch.floor((pos - lo[:, None]) / cell[:, None]), 0,
                     G - 1).to(torch.int32)
    cid = torch.where(vmask, ij[..., 1] * G + ij[..., 0], nc).to(torch.int32)

    # one stable sort over every lane: the key lane·(nc+1) + cid keeps lane
    # b's vertices in sorted slots [b·n, (b+1)·n), in the one-lane order
    key = (cid + _lane_offsets(B, nc + 1, dev)).reshape(-1)
    sk, order = torch.sort(key, stable=True)
    slot = torch.arange(B * n, device=dev)
    rank = slot - torch.searchsorted(sk, sk, side="left")
    lane = slot // n
    sc = sk - lane * (nc + 1)                        # the lane's own cell id
    ok = (rank < cap) & (sc < nc)
    bucket = torch.full((B, nc + 1, cap), n, dtype=torch.int32, device=dev)
    bucket[lane, torch.where(ok, sc, nc).long(), torch.where(ok, rank, 0)] = \
        torch.where(ok, (order - lane * n).to(torch.int32), n)
    inb = torch.zeros(B * n, dtype=torch.bool, device=dev)
    inb[order] = ok
    return cid, bucket, inb.view(B, n)


def _cell_aggregates(pos, w, fcid, cells: int):
    """(mass[cells], weighted-sum[cells, 2], centroid[cells, 2]) per cell of
    a flat index space: ``fcid`` [B, n] int64 is each vertex's cell there
    (lane b's cell c at b·(nc+1) + c, ``cells`` = B·(nc+1))."""
    seg = fcid.reshape(-1)
    M = segment_sum(w.reshape(-1), seg, cells)
    S = segment_sum((w[..., None] * pos).reshape(-1, 2), seg, cells)
    return M, S, S / torch.clamp_min(M, _EPS)[:, None]


def cell_centers_from_box(lo, hi, grid_dim: int):
    """Geometric centers of the G×G cells over the box (lo, hi): [G²+1, 2]
    (sentinel row = 0), or [B, G²+1, 2] for lanes' boxes [B, 2]. Shared by
    the single-device op and the sharded step, which reduces lo/hi over its
    ranks, so the centered second moments agree between the two."""
    G = grid_dim
    cell = grid_cell_size(lo, hi, G)
    ids = torch.arange(G * G, device=lo.device)
    xy = torch.stack([ids % G, ids // G], dim=1).to(torch.float32)
    ctr = lo[..., None, :] + (xy + 0.5) * cell[..., None, :]
    return torch.cat([ctr, ctr.new_zeros(ctr.shape[:-2] + (1, 2))], dim=-2)


def cell_centers(pos, vmask, grid_dim: int):
    """Geometric centers of the G×G cells over the vertices' bounding box:
    [G²+1, 2] (sentinel row = 0), or [B, G²+1, 2] for lanes."""
    return cell_centers_from_box(*_box(pos, vmask), grid_dim)


def _rms(Q, M, S, centers):
    """Per-cell RMS radius from mass M, weighted-position sum S and the
    second moment Q accumulated about ``centers``."""
    mu_rel = S / torch.clamp_min(M, _EPS)[:, None] - centers
    return torch.sqrt(torch.clamp_min(
        Q / torch.clamp_min(M, _EPS) - (mu_rel * mu_rel).sum(dim=1), 0.0))


def _agg_field_9(pos, mu9, m9, cl2, md2, r9=None):
    """Aggregate force field of each vertex's 9 gathered cells:
    pos [B, n, 2], mu9 [B, n, 9, 2], m9 [B, n, 9] → [B, n, 2], optionally
    Plummer-softened by the cells' RMS radii ``r9``; ``cl2``/``md2`` are
    [B, 1, 1]."""
    dx = pos[..., 0:1] - mu9[..., 0]
    dy = pos[..., 1:2] - mu9[..., 1]
    d2 = dx * dx + dy * dy + md2
    if r9 is not None:
        d2 = d2 + r9 * r9
    inv = (cl2 * m9) / d2
    return torch.stack([(dx * inv).sum(dim=-1), (dy * inv).sum(dim=-1)],
                       dim=-1)


def far_corrections(pos, w_out, fcid, inb, M_full, S_full, Q_full,
                    M_out, S_out, Q_out, cl2, md2, *,
                    near9, centers):
    """The force to ADD to the all-cells aggregate term: minus the 9 near
    cells' full aggregates (counted exactly by the near field), plus the
    softened overflow aggregates (minus the vertex's own mass in its own
    cell), plus — for overflow vertices only — the softened in-bucket
    aggregates of their 9 cells. Lanes [B, n] over the flat cell space of
    ``_cell_aggregates``: ``fcid`` [B, n] and ``near9`` [B, n, 9] index the
    per-cell arrays and ``centers`` [B·(nc+1), 2]."""
    mu_full = S_full / torch.clamp_min(M_full, _EPS)[:, None]
    mu_out = S_out / torch.clamp_min(M_out, _EPS)[:, None]
    r_out = _rms(Q_out, M_out, S_out, centers)
    M_in = M_full - M_out
    S_in = S_full - S_out
    mu_in = S_in / torch.clamp_min(M_in, _EPS)[:, None]
    r_in = _rms(Q_full - Q_out, M_in, S_in, centers)

    f = -_agg_field_9(pos, mu_full[near9], M_full[near9], cl2, md2)
    m9 = M_out[near9].clone()
    mu9 = mu_out[near9].clone()
    m_adj = torch.clamp_min(M_out[fcid] - w_out, 0.0)
    s_adj = S_out[fcid] - w_out[..., None] * pos
    m9[..., 4] = m_adj
    mu9[..., 4, :] = s_adj / torch.clamp_min(m_adj, _EPS)[..., None]
    f = f + _agg_field_9(pos, mu9, m9, cl2, md2, r9=r_out[near9])
    f_bkt = _agg_field_9(pos, mu_in[near9], M_in[near9], cl2, md2,
                         r9=r_in[near9])
    return f + torch.where(inb, 0.0, 1.0)[..., None] * f_bkt


#: rows a lane of the near kernel may keep (its near_rows<1..4>)
NEAR_MAX_RT = 4


@functools.lru_cache(maxsize=None)
def near_split(rows: int) -> tuple[int, int]:
    """How a warp's 32 lanes share a cell of ``rows`` bucket rows: (RT, s)
    — s lanes a row, each summing every s-th slot of each neighbor row, and
    RT rows a lane, so a pass covers (32 // s)·RT rows. Chosen for the least
    time a lane, counted in pair terms (8 instructions each) for neighbor
    rows as long as the cell's own: per pass, 9·⌈rows/s⌉ slots of RT pairs
    and a quarter for the slot's load and loop, then ⌈log2 s⌉ shuffle-adds
    (a quarter each) for each of the 2·RT sums."""
    def cost(rt, s):
        passes = -(-rows // ((32 // s) * rt))
        return passes * (9 * -(-rows // s) * (4 * rt + 1)
                         + 2 * rt * (s - 1).bit_length())
    return min(((rt, s) for rt in range(1, NEAR_MAX_RT + 1)
                for s in range(1, 33)),
               key=lambda p: (cost(*p), p[1], -p[0]))


@functools.lru_cache(maxsize=16)
def near_split_table(cap: int, device: torch.device) -> torch.Tensor:
    """int32[cap + 1]: ``(RT << 8) | s`` of ``near_split`` for each row count
    a cell may hold — the kernel reads its cell's entry. Cached per (cap,
    device); callers share the tensor and must not write to it."""
    return torch.tensor([0] + [rt << 8 | s for rt, s in
                               map(near_split, range(1, cap + 1))],
                        dtype=torch.int32, device=device)


def grid_near(pos, mass, vmask, bucket, table, consts) -> torch.Tensor:
    """Exact 3×3 near field → f_near f32[n, 2] (0 for unbucketed vertices).
    pos f32[n, 2]; mass f32[n]; vmask bool[n]; bucket int32[nc+1, cap]
    (sentinel n; each row filled from slot 0); table int32[nc+1, 9]
    (sentinel nc); ``consts`` f32[2] = (C·L², md²) on pos's device
    (``_build.consts_tensor``). Lanes: pos, mass, vmask, bucket (local ids)
    and consts with a leading lane axis B, the table shared → f32[B, n, 2],
    one launch for all B."""
    if pos.dim() == 2:
        return grid_near(pos[None], mass[None], vmask[None], bucket[None],
                         table, consts[None])[0]
    if pos.device.type == "cpu":
        return grid_near_lanes_ref(pos, mass, vmask, bucket, table, consts)
    if pos.device.type != "cuda":
        raise ValueError(f"grid_near: unsupported device {pos.device}")
    B, n, dev = pos.shape[0], pos.shape[1], pos.device
    nc, cap = bucket.shape[1] - 1, int(bucket.shape[2])
    _build.require(pos, "pos", torch.float32, (B, n, 2), dev)
    _build.require(mass, "mass", torch.float32, (B, n), dev)
    _build.require(vmask, "vmask", torch.bool, (B, n), dev)
    _build.require(bucket, "bucket", torch.int32, (B, nc + 1, cap), dev)
    _build.require(table, "table", torch.int32, (nc + 1, 9), dev)
    if pos.data_ptr() % 8:
        raise ValueError("grid_near: pos must be 8-byte aligned (float2 loads)")
    _build.require(consts, "consts", torch.float32, (B, 2), dev)
    packed = torch.empty((B, nc + 1, cap, 4), dtype=torch.float32, device=dev)
    cnt = torch.empty((B, nc + 1), dtype=torch.int32, device=dev)
    f_near = torch.empty((B, n, 2), dtype=torch.float32, device=dev)
    err = _build.load().grid_near_launch(
        pos.data_ptr(), mass.data_ptr(), vmask.data_ptr(), bucket.data_ptr(),
        table.data_ptr(), near_split_table(cap, dev).data_ptr(), n, nc, cap,
        B, consts.data_ptr(), packed.data_ptr(), cnt.data_ptr(),
        f_near.data_ptr(), _build.stream_of(pos))
    _build.count("grid_near", B, n, nc + 1, cap)
    _build.check(err, "grid_near")
    return f_near


def grid_far(pos, cell_xyw, consts) -> torch.Tensor:
    """Every vertex against every cell aggregate: pos f32[n, 2],
    cell_xyw f32[nc, 3] (x, y, mass) → f32[n, 2]; ``consts`` as
    ``grid_near`` takes it. Lanes: pos f32[B, n, 2], cell_xyw f32[B, nc, 3]
    and consts f32[B, 2] → f32[B, n, 2], one launch for all B."""
    if pos.dim() == 2:
        return grid_far(pos[None], cell_xyw[None], consts[None])[0]
    if pos.device.type == "cpu":
        return grid_far_lanes_ref(pos, cell_xyw, consts)
    if pos.device.type != "cuda":
        raise ValueError(f"grid_far: unsupported device {pos.device}")
    B, n, nc, dev = pos.shape[0], pos.shape[1], cell_xyw.shape[1], pos.device
    _build.require(pos, "pos", torch.float32, (B, n, 2), dev)
    _build.require(cell_xyw, "cell_xyw", torch.float32, (B, nc, 3), dev)
    if pos.data_ptr() % 8:
        raise ValueError("grid_far: pos must be 8-byte aligned (float2 loads)")
    _build.require(consts, "consts", torch.float32, (B, 2), dev)
    out = torch.empty((B, n, 2), dtype=torch.float32, device=dev)
    err = _build.load().grid_far_launch(
        pos.data_ptr(), n, cell_xyw.data_ptr(), nc, B, consts.data_ptr(),
        out.data_ptr(), _build.stream_of(pos))
    _build.count("grid_far", B, n, nc)
    _build.check(err, "grid_far")
    return out


def near_field(rows, near9, cells, consts, *, pos=None, w=None,
               col0: int = 0, ncols: int | None = None) -> torch.Tensor:
    """The exact 3×3 near field a row at a time, as the sharded grid step
    calls it (one row per local vertex; ``core/distributed.py``): rows
    f32[R, 2] against the slots of their cells, near9 int32[R, 9] (row ids
    of ``cells``, in [0, ncell)) → f32[R, 2]. Cell t of a row gives its
    columns t·cap .. t·cap + cap − 1; only columns [col0, col0 + ncols)
    count (default: all 9·cap), and columns past 9·cap add 0, so a "model"
    rank passes its chunk of the padded columns. Two forms of ``cells``:
      * index: int32[ncell, cap] of indices into ``pos`` f32[N, 2] and
        ``w`` f32[N] (a zero-weight sentinel row among them);
      * direct: f32[ncell, cap, 3] = (x, y, w) of each slot.
    A slot of weight 0 is empty. ``consts`` as ``grid_near`` takes it.
    One launch of csrc/near_field.cu for all rows."""
    index = pos is not None
    K = 9 * int(cells.shape[1])
    ncols = K - col0 if ncols is None else int(ncols)
    if rows.device.type == "cpu":
        return near_field_ref(rows, near9, cells, consts[0], consts[1],
                              pos=pos, w=w, col0=col0, ncols=ncols)
    if rows.device.type != "cuda":
        raise ValueError(f"near_field: unsupported device {rows.device}")
    R, dev = rows.shape[0], rows.device
    ncell, cap = int(cells.shape[0]), int(cells.shape[1])
    _build.require(rows, "rows", torch.float32, (R, 2), dev)
    _build.require(near9, "near9", torch.int32, (R, 9), dev)
    _build.require(consts, "consts", torch.float32, (2,), dev)
    if index:
        N = int(pos.shape[0])
        _build.require(cells, "cells", torch.int32, (ncell, cap), dev)
        _build.require(pos, "pos", torch.float32, (N, 2), dev)
        _build.require(w, "w", torch.float32, (N,), dev)
        if pos.data_ptr() % 8:
            raise ValueError("near_field: pos must be 8-byte aligned")
    else:
        N = 0
        _build.require(cells, "cells", torch.float32, (ncell, cap, 3), dev)
    if rows.data_ptr() % 8:
        raise ValueError("near_field: rows must be 8-byte aligned")
    if col0 < 0 or ncols < 0:
        raise ValueError(f"near_field: columns {col0}, {ncols}")
    out = torch.empty((R, 2), dtype=torch.float32, device=dev)
    err = _build.load().near_field_launch(
        rows.data_ptr(), near9.data_ptr(), R, cells.data_ptr(), ncell, cap,
        pos.data_ptr() if index else None, w.data_ptr() if index else None,
        N, col0, ncols, consts.data_ptr(), out.data_ptr(),
        _build.stream_of(rows))
    _build.count("near_field", 1, R, ncell, cap, ncols)
    _build.check(err, "near_field")
    return out


def grid_repulsion(pos, mass, vmask, consts, *, grid_dim: int,
                   cell_cap: int) -> torch.Tensor:
    """Grid-approximated FR repulsion: pos f32[n, 2] → forces f32[n, 2].
    ``consts`` as ``grid_near`` takes it; ``far_corrections`` reads its
    two columns. Lanes: pos [B, n, 2], mass/vmask [B, n], consts [B, 2] →
    [B, n, 2]."""
    if grid_dim < 2 or cell_cap < 1:
        raise ValueError(f"grid_dim={grid_dim}, cell_cap={cell_cap}")
    if pos.dim() == 2:
        return grid_repulsion(pos[None], mass[None], vmask[None],
                              consts[None], grid_dim=grid_dim,
                              cell_cap=cell_cap)[0]
    B = pos.shape[0]
    G, cap = grid_dim, cell_cap
    nc = G * G
    cells = B * (nc + 1)
    cl2, md2 = consts[:, 0, None, None], consts[:, 1, None, None]
    w = torch.where(vmask, mass, 0.0)

    cid, bucket, inb = bin_vertices(pos, vmask, G, cap)
    lane0 = _lane_offsets(B, nc + 1, pos.device).long()
    fcid = cid.long() + lane0                      # [B, n] in the flat cells
    M_full, S_full, mu_full = _cell_aggregates(pos, w, fcid, cells)
    w_out = torch.where(inb, 0.0, w)
    M_out, S_out, _ = _cell_aggregates(pos, w_out, fcid, cells)
    centers = cell_centers(pos, vmask, G).reshape(cells, 2)
    rel = pos - centers[fcid]
    q = (rel * rel).sum(dim=-1)
    Q_full = segment_sum((w * q).reshape(-1), fcid.reshape(-1), cells)
    Q_out = segment_sum((w_out * q).reshape(-1), fcid.reshape(-1), cells)

    table = neighbor_table(G, pos.device)
    near9 = table.long()[cid.long()] + lane0[..., None]        # [B, n, 9]
    f_near = grid_near(pos, mass, vmask, bucket, table, consts)
    cell_xyw = torch.cat([mu_full.view(B, nc + 1, 2)[:, :nc],
                          M_full.view(B, nc + 1, 1)[:, :nc]], dim=-1)
    f_far = grid_far(pos, cell_xyw, consts)
    f_far = f_far + far_corrections(pos, w_out, fcid, inb, M_full, S_full,
                                    Q_full, M_out, S_out, Q_out, cl2, md2,
                                    near9=near9, centers=centers)
    return torch.where(vmask[..., None], f_near + f_far, 0.0)
