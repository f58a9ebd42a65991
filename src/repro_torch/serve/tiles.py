"""Quadtree tile pyramid over the multilevel hierarchy: the JAX package's
``serve/tiles.py`` on the port.

The solar-merger hierarchy is a semantic level-of-detail pyramid: level
ℓ+1 is a faithful summary of level ℓ (systems collapse into suns). This
module turns a finished layout's ``HierarchyExport`` into the serving
artifact: every hierarchy level becomes a *zoom band*; within a band,
vertices and edges are binned into the 2^z × 2^z spatial tiles of a
quadtree whose box is shared by ALL bands, so tile (z, tx, ty) addresses
the same region at every zoom.

Coarse-band positions are mass-weighted centroids of the members' FINAL
positions (not the interim coarse drawings, which fine refinement walks
away from), so zooming out never disagrees with the fine drawing.

Binning runs through the port's ``grid_force.bin_vertices`` with a fixed
``box`` on the given device: vertices are presented in descending
aggregate-mass order, so each tile's fixed-capacity bucket is a top-k by
the mass of the solar system the vertex represents — an overfull tile keeps
its heaviest vertices and records the uncapped total. The rest is numpy, as
in the JAX package, and every array equals the JAX package's bit for bit
for the same export.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.multilevel import HierarchyExport
from repro_torch.kernels.grid_force.ops import bin_vertices, grid_cell_size
from repro_torch.utils.device import resolve_device

_EPS = 1e-12


@dataclasses.dataclass
class TileBand:
    """One zoom band: dense per-tile tables over T = 4^zoom tiles.

    Sentinels: vertex/edge slots beyond the per-tile count hold id -1 and
    zero positions. ``tile_total`` is the uncapped vertex count (>''count''
    iff the tile overflowed and kept only its top-k by mass).
    """
    zoom: int
    level: int               # hierarchy level this band serves
    n: int                   # vertices in this band
    m: int                   # edges in this band
    tile_vid: np.ndarray     # int32[T, cap] — band-local vertex id
    tile_rep: np.ndarray     # int32[T, cap] — level-0 representative id
    tile_pos: np.ndarray     # float32[T, cap, 2]
    tile_mass: np.ndarray    # float32[T, cap] — aggregate (subtree) mass
    tile_count: np.ndarray   # int32[T]
    tile_total: np.ndarray   # int32[T]
    tile_eid: np.ndarray     # int32[T, ecap] — band-local edge id
    tile_epos: np.ndarray    # float32[T, ecap, 4] — (x1, y1, x2, y2)
    tile_ecount: np.ndarray  # int32[T]

    @property
    def tiles_per_axis(self) -> int:
        return 1 << self.zoom


@dataclasses.dataclass
class TilePyramid:
    lo: np.ndarray           # float32[2] — shared quadtree box
    hi: np.ndarray           # float32[2]
    tile_cap: int
    edge_cap: int
    bands: list              # list[TileBand], bands[0] = finest


def band_positions(exp: HierarchyExport
                   ) -> tuple[list[np.ndarray], list[np.ndarray]]:
    """(positions, aggregate masses) per band, finest first.

    Aggregate mass of a coarse vertex = number of level-0 vertices it
    represents; positions are mass-weighted member centroids, bottom-up.
    """
    pos = [np.asarray(exp.pos, np.float32)]
    mass = [np.ones(exp.levels[0].n, np.float32)]
    for b, lvl in enumerate(exp.levels[:-1]):
        nn = exp.levels[b + 1].n
        m = np.zeros(nn, np.float32)
        s = np.zeros((nn, 2), np.float32)
        np.add.at(m, lvl.parent, mass[-1])
        np.add.at(s, lvl.parent, mass[-1][:, None] * pos[-1])
        pos.append((s / np.maximum(m, _EPS)[:, None]).astype(np.float32))
        mass.append(m)
    return pos, mass


def zoom_for(n: int, tile_cap: int, max_zoom: int) -> int:
    """Smallest zoom whose mean tile occupancy is ≤ tile_cap/2."""
    occ = max(tile_cap // 2, 1)
    z = 0 if n <= occ else math.ceil(math.log(n / occ, 4))
    return int(np.clip(z, 0, max_zoom))


def tile_coords(pos, lo, hi, zoom: int):
    """int32[..., 2] (tx, ty) — the same float32 ops as ``bin_vertices``
    (the cell size comes from the shared ``grid_cell_size``), on numpy
    arrays (build and reference) or torch tensors (the batched query
    path) alike."""
    G = 1 << zoom
    cell = grid_cell_size(lo, hi, G)
    if isinstance(pos, torch.Tensor):
        t = torch.floor((pos - lo) / cell)
        return torch.clamp(t, 0, G - 1).to(torch.int32)
    t = np.floor((pos - lo) / cell)
    return np.clip(t, 0, G - 1).astype(np.int32)


def _bin_band(pos, agg_mass, rep, edges, lo, hi, zoom: int, level: int,
              tile_cap: int, edge_cap: int, device) -> TileBand:
    n, m = len(pos), len(edges)
    G = 1 << zoom
    T = G * G

    # -- vertices: mass-priority order through bin_vertices (on ``device``) --
    order = np.argsort(-agg_mass, kind="stable")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)
                                   ).to(device)
    cid_o, bucket, _ = bin_vertices(
        t(pos[order]), torch.ones(n, dtype=torch.bool, device=device), G,
        tile_cap, box=(t(lo), t(hi)))
    bucket = bucket[:T].cpu().numpy()                     # [T, cap], sentinel n
    cell_of = np.empty(n, np.int32)
    cell_of[order] = cid_o.cpu().numpy()
    valid = bucket < n
    vid = np.where(valid, order[np.minimum(bucket, n - 1)], -1).astype(np.int32)
    tile_count = valid.sum(axis=1).astype(np.int32)
    tile_total = np.bincount(cell_of, minlength=T).astype(np.int32)
    safe = np.maximum(vid, 0)
    tile_pos = np.where(valid[:, :, None], pos[safe], 0.0).astype(np.float32)
    tile_mass = np.where(valid, agg_mass[safe], 0.0).astype(np.float32)
    tile_rep = np.where(valid, rep[safe].astype(np.int32), -1).astype(np.int32)

    # -- edges: each edge lands in the tile(s) of its endpoints --------------
    if m:
        tc = tile_coords(pos, lo, hi, zoom)
        tid = tc[:, 1].astype(np.int64) * G + tc[:, 0]
        tu, tv = tid[edges[:, 0]], tid[edges[:, 1]]
        eids = np.arange(m, dtype=np.int64)
        prio = agg_mass[edges[:, 0]] + agg_mass[edges[:, 1]]
        etile = np.concatenate([tu, tv[tu != tv]])
        eeid = np.concatenate([eids, eids[tu != tv]])
        eprio = np.concatenate([prio, prio[tu != tv]])
        # per-tile top-k by endpoint mass, ties broken by edge id
        srt = np.lexsort((eeid, -eprio, etile))
        etile, eeid = etile[srt], eeid[srt]
        starts = np.searchsorted(etile, etile, side="left")
        rank = np.arange(len(etile)) - starts
        keep = rank < edge_cap
        tile_eid = np.full((T, edge_cap), -1, np.int32)
        tile_eid[etile[keep], rank[keep]] = eeid[keep]
        tile_ecount = np.bincount(etile[keep], minlength=T).astype(np.int32)
        epos = np.concatenate([pos[edges[:, 0]], pos[edges[:, 1]]],
                              axis=1).astype(np.float32)   # [m, 4]
        esafe = np.maximum(tile_eid, 0)
        tile_epos = np.where((tile_eid >= 0)[:, :, None], epos[esafe], 0.0)
        tile_epos = tile_epos.astype(np.float32)
    else:
        tile_eid = np.full((T, edge_cap), -1, np.int32)
        tile_ecount = np.zeros(T, np.int32)
        tile_epos = np.zeros((T, edge_cap, 4), np.float32)

    return TileBand(zoom=zoom, level=level, n=n, m=m, tile_vid=vid,
                    tile_rep=tile_rep,
                    tile_pos=tile_pos, tile_mass=tile_mass,
                    tile_count=tile_count, tile_total=tile_total,
                    tile_eid=tile_eid, tile_epos=tile_epos,
                    tile_ecount=tile_ecount)


def build_pyramid(exp: HierarchyExport, *, tile_cap: int = 64,
                  edge_cap: int = 96, max_zoom: int = 8,
                  device=None) -> TilePyramid:
    """Build the quadtree tile pyramid from a layout's hierarchy export.
    The vertices are binned on ``device`` (default: the card; the arrays
    are the same on any device), the rest runs in numpy."""
    device = resolve_device(device)
    pos, mass = band_positions(exp)
    lo = pos[0].min(axis=0).astype(np.float32)
    hi = pos[0].max(axis=0).astype(np.float32)
    bands = []
    prev_zoom = max_zoom
    for b, lvl in enumerate(exp.levels):
        zoom = min(zoom_for(lvl.n, tile_cap, max_zoom), prev_zoom)
        prev_zoom = zoom
        band = _bin_band(pos[b], mass[b], lvl.rep,
                         np.asarray(lvl.edges, np.int64).reshape(-1, 2),
                         lo, hi, zoom, b, tile_cap, edge_cap, device)
        if bands and bands[-1].zoom == zoom:
            # two levels mapping to the same zoom: keep only the coarser —
            # band selection ("coarsest band with zoom ≥ z") could never
            # pick the finer one, it would just be stored and gathered
            bands[-1] = band
        else:
            bands.append(band)
    return TilePyramid(lo=lo, hi=hi, tile_cap=tile_cap, edge_cap=edge_cap,
                       bands=bands)
