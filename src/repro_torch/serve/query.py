"""Batched LOD viewport queries, the serving hot path: the JAX package's
``serve/query.py`` on torch.

One batched pass answers B viewports at once: per request, select the zoom
band, enumerate the covered quadtree tiles (row-major, a fixed
``max_tiles`` budget), gather the tiles' dense vertex/edge tables, and
mask. Every band is evaluated for the whole batch and each request's band
is picked with ``where``: bands are few (the hierarchy's depth) and the
work a band is a handful of gathers. The JAX package runs this as one
jitted XLA program (no Pallas kernel lies behind it); the port runs the
same gathers and ``where``s as plain torch ops on the device that holds
the tables (default: the card).

Everything after band selection is gathers and comparisons — no float
arithmetic touches the stored coordinates — and the tile math divides in
float32 with IEEE rounding on every device, so the batched results are
bit-identical to the unpadded numpy resolver (``reference_resolve``, the
oracle). Torch indexing wraps negative indices and raises past the end,
where XLA's gather clamps: ``_cover`` zeroes the ids of invalid tiles, so
every gathered id is in range.

Zoom semantics: a request's ``zoom`` z asks for quadtree tiles of zoom z;
the resolver serves it from the coarsest band whose tile grid is at least
that fine (``band_for_zoom``): coarse summaries for zoomed-out viewports,
full detail only when the viewport is small.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.serve.tiles import TilePyramid, tile_coords
from repro_torch.utils.device import resolve_device

MAX_TILES = 16  # per-request tile-cover budget (row-major truncation; the
# result's "covered" field carries the true wx·wy so clients can tell)

_TABLES = ("tile_vid", "tile_rep", "tile_pos", "tile_mass", "tile_eid",
           "tile_epos")


def band_for_zoom(zooms: np.ndarray, z) -> np.ndarray:
    """Coarsest band whose zoom ≥ z (band 0 if z exceeds the finest)."""
    zs = np.asarray(zooms)
    z = np.asarray(z)
    return np.clip(np.sum(zs[None, ...] >= z[..., None], axis=-1) - 1,
                   0, len(zs) - 1).astype(np.int32)


def _cover(boxes, lo, hi, zoom: int, max_tiles: int):
    """Row-major tile cover of each viewport, truncated to ``max_tiles``.

    boxes f32[B, 4] → (tid i32[B, K], tvalid bool[B, K], covered i32[B] =
    the untruncated wx·wy); the valid tiles are a prefix (k < wx·wy), and
    an invalid tile's id is 0, a row every gather may read. Tile math is
    the shared ``tile_coords`` (bit-identical to binning).
    """
    G = 1 << zoom
    t0 = tile_coords(boxes[:, 0:2], lo, hi, zoom)
    t1 = tile_coords(boxes[:, 2:4], lo, hi, zoom)
    w = torch.clamp_min(t1 - t0 + 1, 1)                  # [B, 2] (≥1 even for
    # an inverted box, keeping the k % w enumeration well-defined)
    k = torch.arange(max_tiles, dtype=torch.int32, device=boxes.device)[None]
    kx = k % w[:, 0:1]
    ky = k // w[:, 0:1]
    tvalid = ky < w[:, 1:2]
    tid = torch.where(tvalid, (t0[:, 1:2] + ky) * G + (t0[:, 0:1] + kx), 0)
    return tid, tvalid, w[:, 0] * w[:, 1]


def _query_band(band: dict, zoom: int, lo, hi, boxes, max_tiles: int
                ) -> dict:
    """Resolve ALL requests against one band's dense tables."""
    tid, tvalid, covered = _cover(boxes, lo, hi, zoom, max_tiles)
    B = boxes.shape[0]
    ti = tid.long()

    vt = band["tile_vid"][ti]                            # [B, K, cap]
    vmask = (vt >= 0) & tvalid[:, :, None]
    rep = torch.where(vmask, band["tile_rep"][ti], -1)
    vpos = torch.where(vmask[..., None], band["tile_pos"][ti], 0.0)
    vmass = torch.where(vmask, band["tile_mass"][ti], 0.0)
    vid = torch.where(vmask, vt, -1)
    bx = boxes[:, None, None, :]
    inside = (vmask
              & (vpos[..., 0] >= bx[..., 0]) & (vpos[..., 1] >= bx[..., 1])
              & (vpos[..., 0] <= bx[..., 2]) & (vpos[..., 1] <= bx[..., 3]))

    et = band["tile_eid"][ti]                            # [B, K, ecap]
    emask = (et >= 0) & tvalid[:, :, None]
    eid = torch.where(emask, et, -1)
    epos = torch.where(emask[..., None], band["tile_epos"][ti], 0.0)

    flat = lambda a: a.reshape((B, -1) + tuple(a.shape[3:]))
    return {"vid": flat(vid), "rep": flat(rep), "vpos": flat(vpos),
            "vmass": flat(vmass), "vmask": flat(vmask),
            "inside": flat(inside), "eid": flat(eid), "epos": flat(epos),
            "emask": flat(emask),
            "tiles": torch.where(tvalid, tid, -1),
            "covered": covered}


def _query_batch(bands: tuple, zooms: tuple, lo, hi, boxes, req_zoom,
                 max_tiles: int = MAX_TILES) -> dict:
    """boxes f32[B, 4], req_zoom i32[B] (tensors on the tables' device) →
    per-request padded slices. ``bands`` is a tuple of dense per-band
    table dicts (uniform caps); ``zooms`` the per-band quadtree zooms."""
    zs = torch.tensor(zooms, dtype=torch.int32, device=boxes.device)
    sel = torch.clamp(
        (zs[None, :] >= req_zoom[:, None]).sum(dim=1) - 1, 0,
        len(zooms) - 1).to(torch.int32)
    out = None
    for b, band in enumerate(bands):
        res = _query_band(band, zooms[b], lo, hi, boxes, max_tiles)
        if out is None:
            out = res
        else:
            pick = sel == b
            out = {k: torch.where(pick.reshape((-1,) + (1,) * (v.dim() - 1)),
                                  v, out[k])
                   for k, v in res.items()}
    out["band"] = sel
    return out


class QueryEngine:
    """The pyramid's dense band tables resident on ``device`` (default: the
    card) and the batched resolver over them.

    Batch sizes are padded to power-of-two buckets, as the JAX package
    pads them to bound its compiled programs: the port's shapes, and so
    its allocator's block sizes, stay logarithmic in the largest batch.
    """

    def __init__(self, pyramid: TilePyramid, max_tiles: int = MAX_TILES,
                 device=None):
        self.device = resolve_device(device)
        self.zooms = tuple(int(b.zoom) for b in pyramid.bands)
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        self.lo = t(np.asarray(pyramid.lo, np.float32))
        self.hi = t(np.asarray(pyramid.hi, np.float32))
        self.max_tiles = max_tiles
        self.bands = tuple({k: t(getattr(b, k)) for k in _TABLES}
                           for b in pyramid.bands)

    @staticmethod
    def _bucket(b: int) -> int:
        return 1 << max(b - 1, 0).bit_length()

    def query(self, boxes: np.ndarray, req_zoom: np.ndarray) -> dict:
        """Resolve B viewports; returns host arrays trimmed to B rows."""
        boxes = np.asarray(boxes, np.float32).reshape(-1, 4)
        req_zoom = np.asarray(req_zoom, np.int32).reshape(-1)
        B = boxes.shape[0]
        Bp = self._bucket(B)
        if Bp != B:
            boxes = np.concatenate(
                [boxes, np.zeros((Bp - B, 4), np.float32)], axis=0)
            req_zoom = np.concatenate(
                [req_zoom, np.zeros(Bp - B, np.int32)])
        out = _query_batch(self.bands, self.zooms, self.lo, self.hi,
                           torch.from_numpy(boxes).to(self.device),
                           torch.from_numpy(req_zoom).to(self.device),
                           self.max_tiles)
        return {k: v[:B].cpu().numpy() for k, v in out.items()}

    def warmup(self, batch_sizes=(1, 16, 64)) -> None:
        for B in batch_sizes:
            self.query(np.zeros((B, 4), np.float32), np.zeros(B, np.int32))


def trim_result(out: dict, i: int) -> dict:
    """Drop padding from request i of a batched result → unpadded arrays
    (the reference resolver's format)."""
    vm = out["vmask"][i]
    em = out["emask"][i]
    return {"band": int(out["band"][i]),
            "covered": int(out["covered"][i]),
            "vid": out["vid"][i][vm], "rep": out["rep"][i][vm],
            "vpos": out["vpos"][i][vm], "vmass": out["vmass"][i][vm],
            "inside": out["inside"][i][vm],
            "eid": out["eid"][i][em], "epos": out["epos"][i][em],
            "tiles": out["tiles"][i][out["tiles"][i] >= 0]}


def random_viewports(lo, hi, zoom_max: int, count: int, seed: int = 0
                     ) -> tuple[np.ndarray, np.ndarray]:
    """Uniform load-generator workload: ``count`` (box, zoom) requests.

    Zooms are uniform over [0, zoom_max]; a zoom-z box spans 1/2^z of the
    pyramid extent at a uniform position — the mix a map-style client
    panning and zooming over the drawing produces.
    """
    rng = np.random.default_rng(seed)
    lo = np.asarray(lo, np.float32)
    hi = np.asarray(hi, np.float32)
    z = rng.integers(0, zoom_max + 1, count).astype(np.int32)
    ext = hi - lo
    w = ext[None, :] / (2.0 ** z)[:, None].astype(np.float32)
    c = lo[None, :] + (rng.random((count, 2)).astype(np.float32)
                       * np.maximum(ext[None, :] - w, 0.0))
    return np.concatenate([c, c + w], axis=1).astype(np.float32), z


def reference_resolve(pyr: TilePyramid, box, zoom: int,
                      max_tiles: int = MAX_TILES) -> dict:
    """Unpadded single-request NumPy resolver — the parity oracle.

    Mirrors the batched path operation for operation (same f32 tile math,
    same row-major truncation, same slot order) so results are
    bit-identical, not just approximately equal.
    """
    zs = np.asarray([b.zoom for b in pyr.bands])
    sel = int(band_for_zoom(zs, np.asarray([zoom]))[0])
    band = pyr.bands[sel]
    G = 1 << band.zoom
    box = np.asarray(box, np.float32).reshape(4)
    lo = np.asarray(pyr.lo, np.float32)
    hi = np.asarray(pyr.hi, np.float32)
    t0 = tile_coords(box[0:2], lo, hi, band.zoom)
    t1 = tile_coords(box[2:4], lo, hi, band.zoom)
    wx, wy = max(int(t1[0] - t0[0] + 1), 1), max(int(t1[1] - t0[1] + 1), 1)
    tids = []
    for k in range(max_tiles):
        kx, ky = k % wx, k // wx
        if ky >= wy:
            break
        tids.append(int((int(t0[1]) + ky) * G + (int(t0[0]) + kx)))

    vids, reps, vposs, vmasss, eids, eposs = [], [], [], [], [], []
    for t in tids:
        vm = band.tile_vid[t] >= 0
        vids.append(band.tile_vid[t][vm])
        reps.append(band.tile_rep[t][vm])
        vposs.append(band.tile_pos[t][vm])
        vmasss.append(band.tile_mass[t][vm])
        em = band.tile_eid[t] >= 0
        eids.append(band.tile_eid[t][em])
        eposs.append(band.tile_epos[t][em])
    cat = lambda xs, w: (np.concatenate(xs) if xs
                         else np.zeros((0,) + w, np.float32))
    vpos = cat(vposs, (2,))
    inside = ((vpos[:, 0] >= box[0]) & (vpos[:, 1] >= box[1])
              & (vpos[:, 0] <= box[2]) & (vpos[:, 1] <= box[3]))
    return {"band": sel,
            "covered": wx * wy,
            "vid": cat(vids, ()).astype(np.int32),
            "rep": cat(reps, ()).astype(np.int32),
            "vpos": vpos, "vmass": cat(vmasss, ()),
            "inside": inside,
            "eid": cat(eids, ()).astype(np.int32),
            "epos": cat(eposs, (4,)),
            "tiles": np.asarray(tids, np.int32)}
