"""The sharded layout supersteps over ``torch.distributed`` (DESIGN.md §4).

The JAX package's ``core/distributed.py`` runs these bodies under
``shard_map`` on a device mesh; the port runs one process a rank, each with
the SPMD-local view of its block, and the collectives of
``torch.distributed`` in place of JAX's:

  all_gather over the vertex axes (tiled) → ``all_gather_into_tensor`` on
                                            the mesh's vertex group
  psum / pmin / pmax                       → ``all_reduce`` SUM / MIN / MAX
  ppermute of the boundary bucket rows     → ``batch_isend_irecv`` between
                                            vertex-axis neighbours (a rank
                                            with no peer gets zeros)
  hierarchical all_to_all                  → ``all_to_all_single`` a
                                            vertex axis

Decomposition, as in the JAX package:
  * per-vertex state is split over the flattened vertex axes VTX =
    ("pod", "data"), or ("data",) on a single pod: rank block
    ``mesh.shard_rows``;
  * the all-pairs partner dimension is split over "model" (rank (v, m)
    takes the rows of its block against column chunk m, then sums the
    partials over "model"), a 2-D decomposition of the interaction matrix;
  * edge lists are pre-sorted by destination block (``partition_edges``),
    so each rank's edge sums land in its own block; source positions come
    from an all-gather over VTX, or from a halo exchange of the boundary
    vertices only (``layout_train_step_halo``);
  * the grid repulsion (mode "grid") bins against the reduced global
    bounding box, sums the per-cell mass / centroid / second-moment
    aggregates over VTX (O(G²) floats), takes the far field from them with
    the cell columns split over "model" (the far kernel, ``grid_far``), and
    resolves the exact 3×3 near field a row per local vertex with the
    near-field kernel (``grid_force.ops.near_field``), from the replicated
    bucket table (all-gather variant) or the band's cells plus the two
    boundary rows received from the neighbouring ranks (halo variant).

Every function of a mesh is SPMD: each rank of the mesh calls it with its
own blocks, in the same order. ``layout_train_step`` returns a step over
rank blocks; the driver's level loop (``run_layout_level``) takes its step
from the process-wide step cache (``core/bucketing.py``) under the key
``("dist_step", engine, mesh key, n_pad, m_pad, cap, mode, grid_dim,
cell_cap, device)``: the entry holds the step and its static buffers, and
each iteration reads its temperature (and stress's α) from device tensors,
so the loop makes no host sync. The step is not captured as a CUDA graph:
capturing NCCL collectives is a later item. The exact and neighbor
repulsions are plain torch, as the JAX package's are plain jnp outside any
Pallas kernel; grid levels run the two grid kernels.

The JAX package's ``layout_step_specs``/``layout_halo_specs`` (shapes for
the dry-run, ROADMAP item 14), ``utils/transfer.io_boundary`` (the transfer
guard's allowance) and ``utils/compat.shard_map`` are JAX shims with no
counterpart here.
"""
from __future__ import annotations

import dataclasses
import time
import warnings

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import bucketing, gila
from repro_torch.graphs.graph import (PaddedGraph, bucket_pad, segment_max,
                                      segment_sum, unique_edges)
from repro_torch.kernels.grid_force import ops as gops
from repro_torch.launch.mesh import Mesh
from repro_torch.utils.device import synchronize


def vtx_axes(mesh: Mesh) -> tuple[str, ...]:
    return mesh.vtx_axes


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


# -- collectives ---------------------------------------------------------------

def _all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """The blocks of ``group``'s ranks concatenated along dim 0, in group
    rank order (the JAX package's tiled ``all_gather``)."""
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    # the call every supported torch has; newer ones name it deprecated
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, x.contiguous(), group=group)
    return out


def _all_reduce(x: torch.Tensor, group, op=dist.ReduceOp.SUM):
    dist.all_reduce(x, op=op, group=group)
    return x


def _cat_zero_row(x: torch.Tensor) -> torch.Tensor:
    """``x`` with one zero row appended: the sentinel of a gathered table."""
    return torch.cat([x, x.new_zeros((1,) + tuple(x.shape[1:]))])


def _consts(C, L, md) -> torch.Tensor:
    """(C·L², md²) as the force kernels take them, from device scalars."""
    return torch.stack([(C * L) * L, md * md])


# -- exact N-body, 2-D decomposed ----------------------------------------------

def _exact_rep(mesh: Mesh, n_pad: int, pos_blk, pos_all, w_all, C, L, md):
    """Rows of this block against column chunk ``model`` of all vertices,
    summed over "model"."""
    chunk = n_pad // mesh.shape["model"]
    c0 = mesh.axis_index("model") * chunk
    cpos, cw = pos_all[c0:c0 + chunk], w_all[c0:c0 + chunk]
    dx = pos_blk[:, 0:1] - cpos[:, 0][None, :]
    dy = pos_blk[:, 1:2] - cpos[:, 1][None, :]
    d2 = dx * dx + dy * dy + md * md
    inv = (C * L * L) * cw[None, :] / d2
    return _all_reduce(torch.stack([(dx * inv).sum(1), (dy * inv).sum(1)],
                                   1), mesh.model_group)


def sharded_nbody(mesh: Mesh, n_pad: int):
    """f(pos_blk[n_loc, 2], w_blk[n_loc], params[3]) → this block's forces,
    2-D decomposed; ``params`` = (C, L, min_dist), ``w`` the vmask-zeroed
    mass."""
    def local(pos_blk, w_blk, params):
        C, L, md = params[0], params[1], params[2]
        pos_all = _all_gather(pos_blk, mesh.vtx_group)
        w_all = _all_gather(w_blk, mesh.vtx_group)
        return _exact_rep(mesh, n_pad, pos_blk, pos_all, w_all, C, L, md)
    return local


# -- message superstep (attraction / merger push) ------------------------------

def _attraction(pos_blk, pos_tab, src, dst_c, seg, emask, ewt, L, md,
                n_loc: int):
    """FR attraction of this block's destination edges: sources read from
    ``pos_tab`` (sentinel row last), sums over the block-local ``seg``."""
    delta = pos_tab[src] - pos_blk[dst_c]
    dist_ = torch.sqrt((delta * delta).sum(1) + md * md)
    f = (dist_ * dist_) / (torch.clamp_min(ewt, 1e-6) * L)
    vec = torch.where(emask[:, None], delta / dist_[:, None] * f[:, None],
                      0.0)
    return segment_sum(vec, seg, n_loc + 1)[:n_loc]


def _edge_index(dst_local, n_loc: int) -> tuple:
    """(destination row clamped into the block, its segment with the
    sentinel n_loc) as int64."""
    d = dst_local.long()
    return torch.clamp(d, 0, n_loc - 1), torch.clamp(d, 0, n_loc)


def sharded_attraction(mesh: Mesh, n_pad: int, m_pad: int):
    """f(pos_blk, src, dst_local, emask, ewt, params) → attraction forces.
    The edge arrays are this rank's block of ``partition_edges``'s output,
    ``dst_local`` already offset into the local vertex block."""
    n_loc = n_pad // mesh.vtx_size

    def local(pos_blk, src, dst_local, emask, ewt, params):
        L, md = params[1], params[2]
        pos_tab = _cat_zero_row(_all_gather(pos_blk, mesh.vtx_group))
        dst_c, seg = _edge_index(dst_local, n_loc)
        return _attraction(pos_blk, pos_tab, src.long(), dst_c, seg, emask,
                           ewt, L, md, n_loc)
    return local


def sharded_push_max(mesh: Mesh, n_pad: int):
    """Distributed merger superstep: broadcast int values, max-combine."""
    n_loc = n_pad // mesh.vtx_size

    def local(vals_blk, src, dst_local, emask):
        vals = _all_gather(vals_blk, mesh.vtx_group)
        vals = torch.cat([vals, vals.new_full((1,), -1)])
        msgs = torch.where(emask, vals[src.long()], -1)
        return segment_max(msgs, torch.clamp(dst_local.long(), 0, n_loc),
                           n_loc + 1, -1)[:n_loc]
    return local


# -- neighbor-list repulsion (fine levels) -------------------------------------

def _neighbor_rep(pos_blk, pos_tab, w_tab, nbr, C, L, md):
    delta = pos_blk[:, None, :] - pos_tab[nbr]
    d2 = (delta * delta).sum(-1) + md * md
    inv = (C * L * L) * w_tab[nbr] / d2
    return (delta * inv[..., None]).sum(1)


def sharded_neighbor_force(mesh: Mesh, n_pad: int, cap: int):
    """f(pos_blk, w_blk, nbr_idx_blk[n_loc, cap], params) — k-hop
    repulsion, partners gathered from the replicated table."""
    def local(pos_blk, w_blk, nbr_idx, params):
        C, L, md = params[0], params[1], params[2]
        pos_tab = _cat_zero_row(_all_gather(pos_blk, mesh.vtx_group))
        w_tab = _cat_zero_row(_all_gather(w_blk, mesh.vtx_group))
        return _neighbor_rep(pos_blk, pos_tab, w_tab, nbr_idx.long(), C, L,
                             md)
    return local


# -- grid-bucketed repulsion, sharded (fine levels of big hierarchies) ---------

def _box(mesh: Mesh, pos_blk, vmask_blk) -> tuple:
    """The valid vertices' bounding box over every vertex block: one MIN
    reduction of (lo, -hi)."""
    big = 3e38
    lo = torch.where(vmask_blk[:, None], pos_blk, big).amin(0)
    hi = torch.where(vmask_blk[:, None], pos_blk, -big).amax(0)
    both = _all_reduce(torch.cat([lo, -hi]), mesh.vtx_group,
                       dist.ReduceOp.MIN)
    return both[:2], -both[2:]


def _halo_rows(mesh: Mesh, band: torch.Tensor) -> tuple:
    """(the previous vertex rank's last band row, the next one's first):
    each rank sends its first row back and its last row forward; a rank
    with no peer on a side receives zeros there."""
    d, vsize = mesh.vtx_index, mesh.vtx_size
    top, bot = torch.zeros_like(band[0]), torch.zeros_like(band[0])
    ops = []
    if d > 0:
        peer = mesh.vtx_peer(d - 1)
        ops += [dist.P2POp(dist.irecv, top, peer, mesh.vtx_group),
                dist.P2POp(dist.isend, band[0].contiguous(), peer,
                           mesh.vtx_group)]
    if d < vsize - 1:
        peer = mesh.vtx_peer(d + 1)
        ops += [dist.P2POp(dist.isend, band[-1].contiguous(), peer,
                           mesh.vtx_group),
                dist.P2POp(dist.irecv, bot, peer, mesh.vtx_group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return top, bot


def _halo_binning(mesh: Mesh, pos_blk, w_blk, lo, hi, G: int, cap: int):
    """The halo variant's binning: local cell ids and stable in-cell ranks
    (the band contract puts a cell's vertices on one rank, so local ranks
    are global ones) → (cid, grank, band-local cell, band_ok, inb)."""
    nc, vmask = G * G, w_blk > 0
    cell = gops.grid_cell_size(lo, hi, G)
    ij = torch.clamp(torch.floor((pos_blk - lo) / cell), 0,
                     G - 1).to(torch.int32)
    cid = torch.where(vmask, ij[:, 1] * G + ij[:, 0], nc).to(torch.int32)
    sc, order = torch.sort(cid, stable=True)
    n_loc = pos_blk.shape[0]
    grank = torch.empty(n_loc, dtype=torch.int64, device=pos_blk.device)
    grank[order] = (torch.arange(n_loc, device=pos_blk.device)
                    - torch.searchsorted(sc, sc, side="left"))
    nc_band = (G // mesh.vtx_size) * G
    lc = cid.long() - mesh.vtx_index * nc_band
    band_ok = (lc >= 0) & (lc < nc_band) & (cid < nc)
    # a band-contract violator counts as bucket overflow: it enters the
    # reduced overflow aggregates, so its neighbors keep a softened view
    # of its mass and it keeps the far field; only its own near field
    # degrades
    return cid, grank, lc, band_ok, (grank < cap) & band_ok


def _halo_near(mesh: Mesh, pos_blk, w_blk, cid, grank, lc, band_ok, inb,
               G: int, cap: int) -> tuple:
    """The halo variant's near-field inputs (near9, slot table): the band's
    bucket slots as (x, y, w), the boundary rows of the two neighbouring
    ranks around them and an empty sentinel row last, and each vertex's 9
    cells in that table."""
    Gb = G // mesh.vtx_size
    nc_band = Gb * G
    xyw = torch.cat([pos_blk, w_blk[:, None]], 1)
    tbl = pos_blk.new_zeros((nc_band + 1, cap, 3))
    tbl[torch.where(inb, lc, nc_band), torch.where(inb, grank, 0)] = \
        torch.where(inb[:, None], xyw, 0.0)
    band = tbl[:nc_band].reshape(Gb, G, cap, 3)
    top, bot = _halo_rows(mesh, band)
    sent = (Gb + 2) * G                                  # the empty row
    ext = torch.cat([top[None], band, bot[None]]).reshape(sent * cap, 3)
    ext = torch.cat([ext, ext.new_zeros((cap, 3))]).reshape(sent + 1, cap, 3)
    cid = cid.long()
    cx, cy = cid % G, cid // G
    ey = cy - mesh.vtx_index * Gb + 1                    # extended row
    near9 = []
    for oy in (-1, 0, 1):
        for ox in (-1, 0, 1):
            nx, ny = cx + ox, cy + oy
            ok = band_ok & (nx >= 0) & (nx < G) & (ny >= 0) & (ny < G)
            near9.append(torch.where(ok, (ey + oy) * G + nx, sent))
    return torch.stack(near9, 1).to(torch.int32), ext


def _near_columns(mesh: Mesh, cap: int) -> tuple:
    """(col0, ncols): this "model" rank's chunk of the 9·cap slots padded
    to a multiple of the model axis."""
    K = 9 * cap
    Kc = _round_up(K, mesh.shape["model"]) // mesh.shape["model"]
    return mesh.axis_index("model") * Kc, Kc


def _grid_rep_local(mesh: Mesh, pos_blk, w_blk, consts, *,
                    grid_dim: int, cell_cap: int, variant: str,
                    pos_all=None, w_all=None):
    """SPMD-local grid repulsion of one vertex block. ``w_blk`` is the
    vmask-zeroed mass (w = 0 ⇔ padding). Term for term the single-device
    ``grid_repulsion``:

      * the global bounding box by MIN reductions over the vertex axes;
      * binning: the all-gather variant reruns ``bin_vertices`` on the
        replicated arrays (cell ids, bucket table and membership equal the
        single-device op's); the halo variant bins its block locally;
      * per-cell raw sums (mass, weighted position, second moment; all and
        overflow only) summed over the vertex axes in one reduction;
      * far field: the far kernel (the JAX package's ``far_all_cells``)
        on the block against this "model" rank's chunk of cells, summed
        over "model", plus ``far_corrections`` from the replicated sums;
      * near field: the near-field kernel a row per local vertex on this
        "model" rank's columns of the 9·cap slots, summed over "model".

    The halo variant assumes the band contract (DESIGN.md §4.3): rank d's
    vertices lie in grid rows [d·G/vsize, (d+1)·G/vsize)."""
    G, cap = grid_dim, cell_cap
    nc, dev = G * G, pos_blk.device
    vmask_blk = w_blk > 0
    lo, hi = _box(mesh, pos_blk, vmask_blk)
    if variant == "halo":
        cid, grank, lc, band_ok, inb = _halo_binning(mesh, pos_blk, w_blk,
                                                     lo, hi, G, cap)
    else:
        if pos_all is None:
            pos_all = _all_gather(pos_blk, mesh.vtx_group)
            w_all = _all_gather(w_blk, mesh.vtx_group)
        cid_all, bucket, inb_all = gops.bin_vertices(pos_all, w_all > 0, G,
                                                     cap)
        cid = mesh.shard_rows(cid_all)
        inb = mesh.shard_rows(inb_all)
    cidl = cid.long()

    # per-cell raw sums, reduced over the vertex axes in one all_reduce,
    # second moments about the cell centers (see cell_centers)
    centers = gops.cell_centers_from_box(lo, hi, G)
    rel = pos_blk - centers[cidl]
    q = (rel * rel).sum(1)
    w_out = torch.where(inb, 0.0, w_blk)
    cols8 = []
    for wv in (w_blk, w_out):
        cols8 += [segment_sum(wv, cidl, nc + 1)[:, None],
                  segment_sum(wv[:, None] * pos_blk, cidl, nc + 1),
                  segment_sum(wv * q, cidl, nc + 1)[:, None]]
    sums = _all_reduce(torch.cat(cols8, 1), mesh.vtx_group)
    M_full, S_full, Q_full = sums[:, 0], sums[:, 1:3], sums[:, 3]
    M_out, S_out, Q_out = sums[:, 4], sums[:, 5:7], sums[:, 7]

    # far field: the block against this "model" rank's chunk of cells
    msize = mesh.shape["model"]
    mu_full = S_full / torch.clamp_min(M_full, gops._EPS)[:, None]
    cell_xyw = torch.cat([mu_full[:nc], M_full[:nc, None]], 1)
    ncp = _round_up(nc, msize)
    chunk = ncp // msize
    if ncp > nc:
        cell_xyw = torch.cat([cell_xyw, cell_xyw.new_zeros((ncp - nc, 3))])
    c0 = mesh.axis_index("model") * chunk
    rep = _all_reduce(gops.grid_far(
        pos_blk, cell_xyw[c0:c0 + chunk].contiguous(), consts),
        mesh.model_group)
    near9_far = gops.neighbor_table(G, dev).long()[cidl]
    rep = rep + gops.far_corrections(
        pos_blk[None], w_out[None], cidl[None], inb[None], M_full, S_full,
        Q_full, M_out, S_out, Q_out, consts[0].view(1, 1, 1),
        consts[1].view(1, 1, 1), near9=near9_far[None], centers=centers)[0]

    # near field: the near-field kernel, a row per local vertex
    col0, ncols = _near_columns(mesh, cap)
    if variant == "halo":
        near9, ext = _halo_near(mesh, pos_blk, w_blk, cid, grank, lc,
                                band_ok, inb, G, cap)
        f_near = gops.near_field(pos_blk, near9, ext, consts, col0=col0,
                                 ncols=ncols)
    else:
        f_near = gops.near_field(pos_blk, near9_far.to(torch.int32), bucket,
                                 consts, pos=_cat_zero_row(pos_all),
                                 w=_cat_zero_row(w_all), col0=col0,
                                 ncols=ncols)
    f_near = _all_reduce(f_near, mesh.model_group)
    rep = rep + torch.where(inb[:, None], f_near, 0.0)
    return torch.where(vmask_blk[:, None], rep, 0.0)


def sharded_grid_force(mesh: Mesh, n_pad: int, grid_dim: int, cell_cap: int,
                       variant: str = "allgather"):
    """f(pos_blk[n_loc, 2], w_blk[n_loc], params[3]) → this block's grid
    repulsion; ``params`` = (C, L, min_dist), ``w`` the vmask-zeroed mass.
    Matches the single-device ``grid_repulsion`` (same grid_dim/cell_cap)
    to float tolerance; see ``_grid_rep_local``."""
    if variant not in ("allgather", "halo"):
        raise ValueError(f"variant {variant!r}")
    if grid_dim < 2 or cell_cap < 1:
        raise ValueError(f"grid_dim={grid_dim}, cell_cap={cell_cap}")
    if n_pad % mesh.vtx_size:
        raise ValueError(f"n_pad {n_pad} over {mesh.vtx_size} vertex ranks")
    if variant == "halo" and grid_dim % mesh.vtx_size:
        raise ValueError(f"halo: grid_dim {grid_dim} over "
                         f"{mesh.vtx_size} vertex ranks")

    def local(pos_blk, w_blk, params):
        return _grid_rep_local(mesh, pos_blk, w_blk,
                               _consts(params[0], params[1], params[2]),
                               grid_dim=grid_dim,
                               cell_cap=cell_cap, variant=variant)
    return local


# -- the full distributed layout step ------------------------------------------

def _fr_update(pos_blk, force, temp):
    norm = torch.sqrt((force * force).sum(1) + 1e-12)
    return pos_blk + force / norm[:, None] * torch.minimum(norm, temp)[:, None]


class DistStep:
    """One sharded refinement iteration of ``engine`` for one shape bucket:
    the entry of the step cache under ``("dist_step", ...)``. ``stage``
    copies one level's rank blocks into the entry's static buffers (and
    gathers the replicated weights and the engine's per-level terms);
    ``__call__(pos_blk, temp, alpha)`` runs one iteration from device
    tensors alone. ``mode`` is "exact" | "neighbor" | "grid"; grid needs
    ``grid_dim``/``cell_cap`` and ignores the neighbor lists. The gila
    engine is the FR superstep (repulsion, attraction, the clamped move);
    the stress engine the maxent-stress Jacobi superstep over this rank's
    destination block, its entropy repulsion the mode's repulsion with C
    scaled by α."""

    def __init__(self, mesh: Mesh, n_pad: int, m_pad: int, cap: int, *,
                 mode: str, grid_dim: int = 0, cell_cap: int = 0,
                 engine: str = "gila"):
        if mode not in ("exact", "neighbor", "grid"):
            raise ValueError(f"mode {mode!r}")
        if engine not in ("gila", "stress"):
            raise ValueError(f"engine {engine!r}")
        if mode == "grid" and (grid_dim < 2 or cell_cap < 1):
            raise ValueError(f"grid_dim={grid_dim}, cell_cap={cell_cap}")
        vs, ms = mesh.vtx_size, mesh.shape["model"]
        if n_pad % (vs * ms) or m_pad % vs or (mode == "neighbor"
                                               and cap % ms):
            raise ValueError(f"n_pad {n_pad}, m_pad {m_pad}, cap {cap} "
                             f"over mesh {mesh.key}")
        self.mesh, self.n_pad, self.m_pad, self.cap = mesh, n_pad, m_pad, cap
        self.mode, self.grid_dim, self.cell_cap = mode, grid_dim, cell_cap
        self.engine = engine
        self.n_loc, self.m_loc = n_pad // vs, m_pad // vs
        self.buf: dict | None = None

    def _allocate(self, device) -> dict:
        n, m, cap = self.n_loc, self.m_loc, self.cap
        z = lambda *s, dt=torch.float32: torch.zeros(s, dtype=dt,
                                                     device=device)
        return dict(w=z(n), nbr=z(n, cap, dt=torch.int64),
                    src=z(m, dt=torch.int64), dst_c=z(m, dt=torch.int64),
                    seg=z(m, dt=torch.int64), emask=z(m, dt=torch.bool),
                    ewt=z(m), params=z(3), w_tab=z(self.n_pad + 1),
                    we=z(m), ell=z(m), rho=z(n))

    def stage(self, w_blk, nbr_blk, src, dst_local, emask, ewt, params):
        """Copy one level's rank blocks (and its params (C, L, min_dist))
        into the static buffers; a collective (the weights' all-gather)."""
        if self.buf is None:
            self.buf = self._allocate(self.mesh.device)
        b = self.buf
        b["w"].copy_(w_blk)
        b["nbr"].copy_(nbr_blk)
        b["src"].copy_(src)
        dst_c, seg = _edge_index(dst_local, self.n_loc)
        b["dst_c"].copy_(dst_c)
        b["seg"].copy_(seg)
        b["emask"].copy_(emask)
        b["ewt"].copy_(ewt)
        b["params"].copy_(torch.as_tensor(params, dtype=torch.float32))
        b["w_tab"].copy_(_cat_zero_row(_all_gather(b["w"],
                                                   self.mesh.vtx_group)))
        if self.engine == "stress":
            ell = torch.clamp_min(b["ewt"], 1e-6) * b["params"][1]
            we = torch.where(b["emask"], 1.0 / (ell * ell), 0.0)
            b["ell"].copy_(ell)
            b["we"].copy_(we)
            b["rho"].copy_(segment_sum(we, b["seg"], self.n_loc + 1)
                           [:self.n_loc])

    def _repulsion(self, pos_blk, pos_tab, C, L, md):
        b, mesh = self.buf, self.mesh
        if self.mode == "exact":
            return _exact_rep(mesh, self.n_pad, pos_blk, pos_tab[:-1],
                              b["w_tab"][:-1], C, L, md)
        if self.mode == "grid":
            return _grid_rep_local(mesh, pos_blk, b["w"], _consts(C, L, md),
                                   grid_dim=self.grid_dim,
                                   cell_cap=self.cell_cap,
                                   variant="allgather",
                                   pos_all=pos_tab[:-1],
                                   w_all=b["w_tab"][:-1])
        # the neighbor cap split over "model": a 2-D decomposition
        cc = self.cap // mesh.shape["model"]
        c0 = mesh.axis_index("model") * cc
        return _all_reduce(_neighbor_rep(pos_blk, pos_tab, b["w_tab"],
                                         b["nbr"][:, c0:c0 + cc], C, L, md),
                           mesh.model_group)

    def __call__(self, pos_blk, temp, alpha=None) -> torch.Tensor:
        b = self.buf
        C, L, md = b["params"][0], b["params"][1], b["params"][2]
        pos_tab = _cat_zero_row(_all_gather(pos_blk, self.mesh.vtx_group))
        if self.engine == "gila":
            rep = self._repulsion(pos_blk, pos_tab, C, L, md)
            att = _attraction(pos_blk, pos_tab, b["src"], b["dst_c"],
                              b["seg"], b["emask"], b["ewt"], L, md,
                              self.n_loc)
            return _fr_update(pos_blk, rep + att, temp)
        # stress: the entropy term is the repulsion field with C·α
        rep = self._repulsion(pos_blk, pos_tab, alpha * C, L, md)
        ps = pos_tab[b["src"]]
        delta = pos_blk[b["dst_c"]] - ps
        dist_ = torch.sqrt((delta * delta).sum(1) + md * md)
        tgt = ps + delta / dist_[:, None] * b["ell"][:, None]
        vec = torch.where(b["emask"][:, None], b["we"][:, None] * tgt, 0.0)
        num = segment_sum(vec, b["seg"], self.n_loc + 1)[:self.n_loc]
        rho = b["rho"]
        new = (num + rep) / torch.clamp_min(rho, 1e-12)[:, None]
        new = torch.where(rho[:, None] > 0, new, pos_blk)
        return _fr_update(pos_blk, new - pos_blk, temp)


def layout_train_step(mesh: Mesh, n_pad: int, m_pad: int, cap: int,
                      mode: str = "neighbor", grid_dim: int = 0,
                      cell_cap: int = 0, engine: str = "gila"):
    """One full distributed refinement iteration for ``engine``: ``step(
    pos_blk, w_blk, nbr_idx_blk, src, dst_local, emask, ewt, params,
    temp)`` (stress: one more scalar ``alpha`` after ``temp``) takes this
    rank's blocks (``mesh.shard_rows`` of the global arrays, where the JAX
    package returns their shardings) and returns its new positions. Grid
    mode ignores the neighbor lists (pass cap = 1 dummies)."""
    entry = DistStep(mesh, n_pad, m_pad, cap, mode=mode, grid_dim=grid_dim,
                     cell_cap=cell_cap, engine=engine)

    def step(pos_blk, w_blk, nbr_idx, src, dst_local, emask, ewt, params,
             temp, alpha=None):
        entry.stage(w_blk, nbr_idx, src, dst_local, emask, ewt, params)
        scalar = lambda x: (None if x is None else torch.as_tensor(
            x, dtype=torch.float32, device=pos_blk.device))
        return entry(pos_blk, scalar(temp), scalar(alpha))
    return step


def _all_to_all_vtx(mesh: Mesh, send: torch.Tensor) -> torch.Tensor:
    """The personalized all-to-all over the vertex axes, a stage an axis
    (pod, then data): ``send`` [P, halo, 3] → what each peer sent here."""
    shape = tuple(mesh.shape[a] for a in mesh.vtx_axes)
    recv = send.reshape(shape + tuple(send.shape[1:]))
    for d, ax in enumerate(mesh.vtx_axes):
        x = recv.movedim(d, 0).contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=mesh.axis_groups[ax])
        recv = out.movedim(0, d)
    return recv.reshape(send.shape[0], -1, 3)


def layout_train_step_halo(mesh: Mesh, n_pad: int, m_pad: int, cap: int,
                           halo: int, mode: str = "neighbor",
                           grid_dim: int = 0, cell_cap: int = 0):
    """GiLA iteration with a HALO EXCHANGE in place of the position
    all-gather: with a Spinner partition almost every k-hop neighbor is
    local, and each rank needs only its peers' boundary positions. Host
    preprocessing gives each rank ``send_idx[P, halo]`` (the local vertices
    each peer needs, sentinel-padded) and neighbor and source lists in
    [local | halo slot | sentinel] coordinates. → ``step(pos_blk, w_blk,
    nbr_local, send_idx, src_local, dst_local, emask, ewt, params, temp)``
    over this rank's blocks. ``mode="grid"`` takes the sharded grid
    repulsion's halo variant instead (``nbr_local`` ignored; the band
    contract of ``_grid_rep_local``)."""
    vsize = mesh.vtx_size
    n_loc = n_pad // vsize
    if mode == "grid" and (grid_dim < 2 or cell_cap < 1
                           or grid_dim % vsize):
        raise ValueError(f"grid_dim={grid_dim}, cell_cap={cell_cap} over "
                         f"{vsize} vertex ranks")

    def step(pos_blk, w_blk, nbr_local, send_idx, src_local, dst_local,
             emask, ewt, params, temp):
        C, L, md = params[0], params[1], params[2]
        temp = torch.as_tensor(temp, dtype=torch.float32,
                               device=pos_blk.device)
        sidx = torch.clamp(send_idx.long(), 0, n_loc)
        send = torch.cat([_cat_zero_row(pos_blk)[sidx],
                          _cat_zero_row(w_blk)[sidx][..., None]], -1)
        recv = _all_to_all_vtx(mesh, send)
        full_pos = _cat_zero_row(torch.cat([pos_blk,
                                            recv[..., :2].reshape(-1, 2)]))
        full_w = _cat_zero_row(torch.cat([w_blk, recv[..., 2].reshape(-1)]))
        if mode == "grid":
            rep = _grid_rep_local(mesh, pos_blk, w_blk, _consts(C, L, md),
                                  grid_dim=grid_dim,
                                  cell_cap=cell_cap, variant="halo")
        else:
            rep = _neighbor_rep(pos_blk, full_pos, full_w, nbr_local.long(),
                                C, L, md)
        dst_c, seg = _edge_index(dst_local, n_loc)
        att = _attraction(pos_blk, full_pos, src_local.long(), dst_c, seg,
                          emask, ewt, L, md, n_loc)
        return _fr_update(pos_blk, rep + att, temp)
    return step


# -- host-side level driver (driver="multigila_dist" in core/multilevel.py) ----

def partition_edges(src, dst, emask, ewt, n_pad: int, vsize: int,
                    bucket: bool = False):
    """Host-side Spinner-order edge partition: group edges by the vertex
    block that owns their destination, pad every block to the longest, and
    offset destinations into block-local coordinates.

    Returns (src[m_pad2], dst_local[m_pad2], emask[m_pad2], ewt[m_pad2],
    m_pad2), laid out so that block d of ``vsize`` equal blocks is rank d's
    destination block (padding edges: src = n_pad sentinel, mask off).
    ``bucket=True`` rounds the block length up to its pow2 bucket (floor
    64), so that the step cache keyed on m_pad sees O(log) lengths."""
    src = np.asarray(src)
    dst = np.asarray(dst)
    emask = np.asarray(emask)
    ewt = np.asarray(ewt)
    n_loc = n_pad // vsize
    src, dst, ewt = src[emask], dst[emask], ewt[emask]
    owner = dst // n_loc
    m_loc = max(int(np.bincount(owner, minlength=vsize).max()), 1)
    if bucket:
        m_loc = bucket_pad(m_loc, minimum=64)
    S = np.full((vsize, m_loc), n_pad, np.int32)
    DL = np.zeros((vsize, m_loc), np.int32)
    EM = np.zeros((vsize, m_loc), bool)
    EW = np.ones((vsize, m_loc), np.float32)
    for d in range(vsize):
        sel = owner == d
        k = int(sel.sum())
        S[d, :k] = src[sel]
        DL[d, :k] = dst[sel] - d * n_loc
        EM[d, :k] = True
        EW[d, :k] = ewt[sel]
    return (S.reshape(-1), DL.reshape(-1), EM.reshape(-1), EW.reshape(-1),
            vsize * m_loc)


def cached_layout_step(mesh: Mesh, n_pad: int, m_pad: int, cap: int, *,
                       mode: str, grid_dim: int = 0, cell_cap: int = 0,
                       engine: str = "gila") -> tuple:
    """(the process-wide cached ``DistStep`` of one shape bucket, fresh):
    every level and graph of the bucket reuses the entry and its buffers."""
    key = ("dist_step", engine, mesh.key, n_pad, m_pad, cap, mode, grid_dim,
           cell_cap, str(mesh.device))
    return bucketing.STEP_CACHE.get(
        key, lambda: DistStep(mesh, n_pad, m_pad, cap, mode=mode,
                              grid_dim=grid_dim, cell_cap=cell_cap,
                              engine=engine))


@dataclasses.dataclass
class LevelRun:
    """One level staged for the sharded loop: the step, this rank's
    position block and the per-iteration temperatures (and stress's α) as
    device tensors. ``iterate`` runs iterations without a host sync;
    ``gather`` all-gathers the positions (every rank gets all of them)."""
    step: DistStep
    fresh: bool
    pos: torch.Tensor
    temps: torch.Tensor
    alphas: torch.Tensor | None
    valid: torch.Tensor           # bool[g.n_pad]: w > 0

    @property
    def iters(self) -> int:
        return int(self.temps.shape[0])

    def iterate(self, it0: int = 0, it1: int | None = None) -> None:
        for it in range(it0, self.iters if it1 is None else it1):
            self.pos = self.step(self.pos, self.temps[it],
                                 None if self.alphas is None
                                 else self.alphas[it])

    def gather(self) -> torch.Tensor:
        """Positions [g.n_pad, 2] on every rank, padding zeroed."""
        full = _all_gather(self.pos, self.step.mesh.vtx_group)
        n = self.valid.shape[0]
        return torch.where(self.valid[:, None], full[:n], 0.0)


def _schedule_values(start: float, decay: float, iters: int) -> np.ndarray:
    """float32[iters]: start, start·decay, ... annealed in float64 on the
    host and rounded an iteration at a time, as the JAX package stages
    them."""
    out = np.empty(iters, np.float32)
    v = start
    for it in range(iters):
        out[it] = v
        v *= decay
    return out


def prepare_level(mesh: Mesh, g: PaddedGraph, pos0, sched, *,
                  ideal_len: float, rep_const: float, min_dist: float = 1e-3,
                  seed: int = 0, bucket: bool = True) -> LevelRun:
    """The host work of one level (replicated on every rank): re-pad to
    mesh-divisible sizes, partition the edges by destination block, build
    the k-hop lists in neighbor mode (global indices into the replicated
    position table), take the cached step and stage this rank's blocks."""
    if g.device != mesh.device:
        raise ValueError(f"graph on {g.device}, mesh on {mesh.device}")
    dev = g.device
    vsize, msize = mesh.vtx_size, mesh.shape["model"]
    n_pad = _round_up(g.n_pad, vsize * msize)
    w = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    w[:g.n_pad] = torch.where(g.vmask, g.mass, 0.0)
    pos = torch.zeros((n_pad, 2), dtype=torch.float32, device=dev)
    pos[:g.n_pad] = pos0.to(device=dev, dtype=torch.float32)[:g.n_pad]
    pos = torch.where(w[:, None] > 0, pos, 0.0)

    src, dst_local, emask, ewt, m_pad = partition_edges(
        g.src.cpu().numpy(), g.dst.cpu().numpy(), g.emask.cpu().numpy(),
        g.ewt.cpu().numpy(), n_pad, vsize, bucket=bucket)
    if sched.mode == "neighbor":
        cap = _round_up(sched.cap, msize)
        idx, mask = gila.khop_neighbors(unique_edges(g), g.n, sched.k, cap,
                                        seed)
        nbr = np.full((n_pad, cap), n_pad, np.int32)
        nbr[:g.n] = np.where(mask, idx, n_pad)
    else:
        cap = 1
        nbr = np.full((n_pad, 1), n_pad, np.int32)

    step, fresh = cached_layout_step(mesh, n_pad, m_pad, cap,
                                     mode=sched.mode,
                                     grid_dim=sched.grid_dim,
                                     cell_cap=sched.cell_cap,
                                     engine=sched.engine)
    blk = lambda a: torch.from_numpy(
        a.reshape((vsize, -1) + a.shape[1:])[mesh.vtx_index]).to(dev)
    step.stage(mesh.shard_rows(w), blk(nbr), blk(src), blk(dst_local),
               blk(emask), blk(ewt), [rep_const, ideal_len, min_dist])
    temps = _schedule_values(sched.temp0, sched.temp_decay, sched.iters)
    alphas = None
    if sched.engine == "stress":
        from repro_torch.core.stress import alpha_schedule
        alphas = torch.from_numpy(_schedule_values(
            *alpha_schedule(sched.iters), sched.iters)).to(dev)
    return LevelRun(step=step, fresh=fresh,
                    pos=mesh.shard_rows(pos).clone(),
                    temps=torch.from_numpy(temps).to(dev), alphas=alphas,
                    valid=(w[:g.n_pad] > 0))


def run_layout_level(mesh: Mesh, g: PaddedGraph, pos0, sched, *,
                     ideal_len: float, rep_const: float,
                     min_dist: float = 1e-3, seed: int = 0,
                     bucket: bool = True,
                     phases: dict | None = None) -> torch.Tensor:
    """Lay out ONE hierarchy level with the distributed superstep →
    positions [g.n_pad, 2] on g's device (padding zeroed), the same on
    every rank: the multilevel driver's per-level refinement under
    ``driver="multigila_dist"``. ``phases`` (a ``LayoutStats.
    phase_seconds``) gets the first iteration of a cold cache entry under
    ``compile`` (the collectives' first use, the allocations) and the
    rest, host work included and ended by a device synchronize, under
    ``refine``."""
    t0 = time.perf_counter()
    run = prepare_level(mesh, g, pos0, sched, ideal_len=ideal_len,
                        rep_const=rep_const, min_dist=min_dist, seed=seed,
                        bucket=bucket)
    it0 = 0
    if run.fresh and run.iters:
        t1 = time.perf_counter()
        run.iterate(0, 1)
        synchronize(g.device)
        warm = time.perf_counter() - t1
        bucketing.add_phase(phases, "compile", warm)
        t0 += warm
        it0 = 1
    run.iterate(it0)
    out = run.gather()
    synchronize(g.device)
    bucketing.add_phase(phases, "refine", time.perf_counter() - t0)
    return out
