"""Tile-pyramid persistence and an LRU tile cache: the JAX package's
``serve/store.py`` (numpy only), copied, with its on-disk format.

On disk a pyramid is a directory of npz shards — one per non-empty tile,
keyed by ``(band, tx, ty)`` — plus a ``manifest.json`` recording the
quadtree box, band metadata (zoom, n, m, shard list), tile capacities and
a content digest. The shard names, array keys, manifest and digest are the
JAX package's, so a pyramid written by either package loads in the other.
Writes go through ``ckpt.save_npz`` (tmp → fsync → rename; the directory
likewise), so a killed builder never leaves a pyramid a reader would pick
up.

``TileStore`` is the read side: per-tile access with an LRU cache (the
serving hot set), and ``band_dense`` to assemble the dense per-band tables
that the batched query engine (serve/query.py) keeps on the device.
"""
from __future__ import annotations

import json
import os
import shutil
from collections import OrderedDict

import numpy as np

from repro_torch.ckpt import array_digest, load_npz, save_npz
from repro_torch.serve.tiles import TileBand, TilePyramid

MANIFEST = "manifest.json"

# tile-shard array keys ↔ TileBand per-tile rows
_V_KEYS = ("vid", "rep", "pos", "mass")
_E_KEYS = ("eid", "epos")


def _shard_name(band: int, tx: int, ty: int) -> str:
    return f"band{band}_x{tx}_y{ty}.npz"


def _tile_arrays(band: TileBand, t: int) -> dict[str, np.ndarray]:
    return {"vid": band.tile_vid[t], "rep": band.tile_rep[t],
            "pos": band.tile_pos[t], "mass": band.tile_mass[t],
            "eid": band.tile_eid[t], "epos": band.tile_epos[t],
            "count": band.tile_count[t:t + 1],
            "total": band.tile_total[t:t + 1],
            "ecount": band.tile_ecount[t:t + 1]}


def save_pyramid(path: str, pyr: TilePyramid) -> str:
    """Atomically persist a pyramid directory; returns the final path."""
    tmp = path.rstrip("/") + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    digest_arrays: dict[str, np.ndarray] = {}
    bands_meta = []
    for b, band in enumerate(pyr.bands):
        G = band.tiles_per_axis
        nonempty = np.nonzero((band.tile_count > 0)
                              | (band.tile_ecount > 0))[0]
        tiles = []
        for t in nonempty:
            tx, ty = int(t % G), int(t // G)
            arrs = _tile_arrays(band, int(t))
            save_npz(os.path.join(tmp, _shard_name(b, tx, ty)), arrs)
            for k, a in arrs.items():
                digest_arrays[f"{b}/{tx}/{ty}/{k}"] = np.asarray(a)
            tiles.append([tx, ty])
        bands_meta.append({"zoom": band.zoom, "level": band.level,
                           "n": band.n, "m": band.m, "tiles": tiles})
    manifest = {"bbox": [float(x) for x in np.concatenate([pyr.lo, pyr.hi])],
                "tile_cap": pyr.tile_cap, "edge_cap": pyr.edge_cap,
                "levels": len(pyr.bands), "bands": bands_meta,
                "digest": array_digest(digest_arrays)}
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    # displace any existing pyramid aside-first: ``path`` only ever holds a
    # complete pyramid, and a crash between the renames leaves the previous
    # one intact at ``.old`` instead of rmtree'd into nothing
    old = path.rstrip("/") + ".old"
    if os.path.exists(old):
        shutil.rmtree(old)
    if os.path.exists(path):
        os.rename(path, old)
    os.rename(tmp, path)
    shutil.rmtree(old, ignore_errors=True)
    return path


class TileStore:
    """Read side of a persisted pyramid: manifest + LRU-cached tile shards."""

    def __init__(self, path: str, cache_tiles: int = 4096):
        self.path = path
        with open(os.path.join(path, MANIFEST)) as f:
            self.manifest = json.load(f)
        bbox = np.asarray(self.manifest["bbox"], np.float32)
        self.lo, self.hi = bbox[:2], bbox[2:]
        self.tile_cap = int(self.manifest["tile_cap"])
        self.edge_cap = int(self.manifest["edge_cap"])
        self.levels = int(self.manifest["levels"])
        self._present = [set(map(tuple, bm["tiles"]))
                         for bm in self.manifest["bands"]]
        self.cache_tiles = cache_tiles
        self._cache: OrderedDict = OrderedDict()
        self.hits = 0
        self.misses = 0

    def band_meta(self, band: int) -> dict:
        return self.manifest["bands"][band]

    def _empty_tile(self) -> dict[str, np.ndarray]:
        cap, ecap = self.tile_cap, self.edge_cap
        return {"vid": np.full(cap, -1, np.int32),
                "rep": np.full(cap, -1, np.int32),
                "pos": np.zeros((cap, 2), np.float32),
                "mass": np.zeros(cap, np.float32),
                "eid": np.full(ecap, -1, np.int32),
                "epos": np.zeros((ecap, 4), np.float32),
                "count": np.zeros(1, np.int32),
                "total": np.zeros(1, np.int32),
                "ecount": np.zeros(1, np.int32)}

    def tile(self, band: int, tx: int, ty: int) -> dict[str, np.ndarray]:
        key = (band, tx, ty)
        if key in self._cache:
            self.hits += 1
            self._cache.move_to_end(key)
            return self._cache[key]
        self.misses += 1
        if (tx, ty) in self._present[band]:
            arrs = load_npz(os.path.join(self.path, _shard_name(band, tx, ty)))
        else:
            arrs = self._empty_tile()
        self._cache[key] = arrs
        while len(self._cache) > self.cache_tiles:
            self._cache.popitem(last=False)
        return arrs

    def band_dense(self, band: int) -> TileBand:
        """Assemble the dense per-band tables (empty tiles → sentinels)."""
        bm = self.band_meta(band)
        G = 1 << bm["zoom"]
        T = G * G
        cap, ecap = self.tile_cap, self.edge_cap
        out = TileBand(
            zoom=bm["zoom"], level=bm["level"], n=bm["n"], m=bm["m"],
            tile_vid=np.full((T, cap), -1, np.int32),
            tile_rep=np.full((T, cap), -1, np.int32),
            tile_pos=np.zeros((T, cap, 2), np.float32),
            tile_mass=np.zeros((T, cap), np.float32),
            tile_count=np.zeros(T, np.int32),
            tile_total=np.zeros(T, np.int32),
            tile_eid=np.full((T, ecap), -1, np.int32),
            tile_epos=np.zeros((T, ecap, 4), np.float32),
            tile_ecount=np.zeros(T, np.int32))
        for (tx, ty) in sorted(self._present[band]):
            t = ty * G + tx
            a = self.tile(band, tx, ty)
            out.tile_vid[t] = a["vid"]
            out.tile_rep[t] = a["rep"]
            out.tile_pos[t] = a["pos"]
            out.tile_mass[t] = a["mass"]
            out.tile_count[t] = a["count"][0]
            out.tile_total[t] = a["total"][0]
            out.tile_eid[t] = a["eid"]
            out.tile_epos[t] = a["epos"]
            out.tile_ecount[t] = a["ecount"][0]
        return out

    def verify(self) -> bool:
        """Recompute the shard digest and compare against the manifest."""
        digest_arrays: dict[str, np.ndarray] = {}
        for b, present in enumerate(self._present):
            for (tx, ty) in present:
                arrs = load_npz(
                    os.path.join(self.path, _shard_name(b, tx, ty)))
                for k, a in arrs.items():
                    digest_arrays[f"{b}/{tx}/{ty}/{k}"] = a
        return array_digest(digest_arrays) == self.manifest["digest"]


def load_pyramid(path: str, *, validate: bool = False) -> TilePyramid:
    """Round-trip read: reassemble the full dense TilePyramid."""
    store = TileStore(path, cache_tiles=0)
    if validate and not store.verify():
        raise IOError(f"tile pyramid {path} failed digest validation")
    bands = [store.band_dense(b) for b in range(store.levels)]
    return TilePyramid(lo=store.lo, hi=store.hi, tile_cap=store.tile_cap,
                       edge_cap=store.edge_cap, bands=bands)
