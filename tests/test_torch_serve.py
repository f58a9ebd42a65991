"""The port's serving layer — the hierarchy export, the tile pyramid, its
store, the batched viewport queries, ``bin_vertices(box=)`` and the npz
shards — held to the live JAX package on the CPU.

Tolerances: everything here is integer tables, gathers and float32 tile
math, so it is held bit for bit — export structure (``n``, ``edges``,
``parent``, ``rep``), every pyramid band array built from one export, every
query result (against the JAX ``QueryEngine`` and the numpy oracle
``reference_resolve``), store bytes, manifest and digests. The export's
``pos`` is the returned drawing, bit for bit, and the drawing a layout:
held as ``test_torch_layout.py`` holds one, NELD within 0.05 and CRE
within 0.15 of JAX's, on the disconnected graph of delaunay components
laid out with the default schedule. On gnp(1500) — the JAX serving tests'
graph, with their short schedule (60 / 10 iterations) — only NELD is held:
that drawing is unconverged, with ~118 crossings per edge, where CRE's
absolute 0.15 (set for drawings of a few crossings per edge) is a 0.1%
bound on a chaotic count.
"""
import json
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import jax.numpy as jnp

from repro import ckpt as jax_ckpt
from repro import serve as jax_serve
from repro.core import LayoutConfig as JaxConfig
from repro.core import multigila_layout as jax_layout
from repro.graphs import generators as G
from repro.graphs.metrics import cre as jax_cre
from repro.graphs.metrics import neld as jax_neld
from repro.kernels.grid_force import ops as jax_grid
from repro.serve import tiles as jax_tiles
from repro_torch import ckpt
from repro_torch.core import LayoutConfig, multigila_layout
from repro_torch.graphs.metrics import cre, neld
from repro_torch.kernels.grid_force import ops as grid_ops
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import (MAX_TILES, MicroBatcher, QueryEngine,
                               TileStore, band_for_zoom, build_pyramid,
                               load_pyramid, reference_resolve, save_pyramid,
                               trim_result)
from repro_torch.serve import tiles
from repro_torch.serve.query import random_viewports

NELD_DELTA, CRE_DELTA = 0.05, 0.15
CFG = dict(seed=0, coarsest_iters=60, finest_iters=10)
PYR = dict(tile_cap=32, edge_cap=48, max_zoom=6)
BAND_FIELDS = ("tile_vid", "tile_rep", "tile_pos", "tile_mass", "tile_count",
               "tile_total", "tile_eid", "tile_epos", "tile_ecount")


def _disconnected():
    """Two delaunay components of different depths, a path and an isolated
    vertex, interleaved ids."""
    (e1, n1), (e2, n2) = G.delaunay(300, 1), G.delaunay(120, 2)
    e = np.concatenate([e1, e2 + n1, [[n1 + n2, n1 + n2 + 1],
                                      [n1 + n2 + 1, n1 + n2 + 2]]])
    n = n1 + n2 + 4
    perm = np.random.default_rng(0).permutation(n)
    return perm[e].astype(np.int64), n


# name: (graph, the layout's config, CRE held)
GRAPHS = {"gnp1500": (lambda: G.gnp(1500, 4.0, seed=0), CFG, False),
          "disconnected": (_disconnected, dict(seed=0), True)}


@pytest.fixture(scope="module")
def exports():
    """{name: (edges, n, JAX (pos, exp), port (pos, exp))}."""
    out = {}
    for name, (make, cfg, _) in GRAPHS.items():
        e, n = make()
        pj, _, xj = jax_layout(e, n, JaxConfig(**cfg), export=True)
        pt, _, xt = multigila_layout(e, n, LayoutConfig(**cfg), export=True,
                                     device="cpu")
        out[name] = (e, n, (np.asarray(pj), xj), (pt, xt))
    return out


@pytest.fixture(scope="module")
def pyramids(exports):
    """(JAX pyramid, port pyramid), both built from the JAX export."""
    _, _, (_, xj), _ = exports["gnp1500"]
    return (jax_serve.build_pyramid(xj, **PYR),
            build_pyramid(xj, **PYR, device="cpu"))


def _bits(a):
    a = np.asarray(a)
    return a.view(np.int32) if a.dtype == np.float32 else a


@pytest.mark.parametrize("name", list(GRAPHS))
def test_export_equals_jax(exports, name):
    e, n, (pj, xj), (pt, xt) = exports[name]
    assert len(xt.levels) == len(xj.levels) > 1
    for a, b in zip(xt.levels, xj.levels):
        assert a.n == b.n
        for f in ("edges", "rep"):
            assert getattr(a, f).dtype == getattr(b, f).dtype
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        assert (a.parent is None) == (b.parent is None)
        if a.parent is not None:
            assert a.parent.dtype == b.parent.dtype == np.int32
            assert np.array_equal(a.parent, b.parent)
    assert np.array_equal(xt.pos, pt) and xt.pos.shape == (n, 2)
    assert abs(neld(pt, e) - jax_neld(pj, e)) <= NELD_DELTA
    if GRAPHS[name][2]:
        assert abs(cre(pt, e) - jax_cre(pj, e)) <= CRE_DELTA


def test_pyramid_from_one_export_equals_jax(pyramids):
    ref, port = pyramids
    assert np.array_equal(port.lo, ref.lo) and np.array_equal(port.hi, ref.hi)
    assert (port.tile_cap, port.edge_cap) == (ref.tile_cap, ref.edge_cap)
    assert len(port.bands) == len(ref.bands) > 2
    for a, b in zip(port.bands, ref.bands):
        assert (a.zoom, a.level, a.n, a.m) == (b.zoom, b.level, b.n, b.m)
        for f in BAND_FIELDS:
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert np.array_equal(_bits(x), _bits(y)), f
    assert any((b.tile_total > b.tile_count).any() for b in port.bands)


def test_band_positions_and_coords_equal_jax(exports, pyramids):
    _, _, (_, xj), _ = exports["gnp1500"]
    pos, mass = tiles.band_positions(xj)
    pj, mj = jax_tiles.band_positions(xj)
    for a, b in zip(pos + mass, pj + mj):
        assert np.array_equal(_bits(a), _bits(b))
    ref, port = pyramids
    for z in range(8):
        want = jax_tiles.tile_coords(pos[0], ref.lo, ref.hi, z)
        assert np.array_equal(tiles.tile_coords(pos[0], port.lo, port.hi, z),
                              want)
        t = lambda a: torch.from_numpy(np.asarray(a, np.float32))
        got = tiles.tile_coords(t(pos[0]), t(port.lo), t(port.hi), z)
        assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)
        xla = jax_tiles.tile_coords(jnp.asarray(pos[0]), jnp.asarray(ref.lo),
                                    jnp.asarray(ref.hi), z, xp=jnp)
        assert np.array_equal(np.asarray(xla), want)


def _viewports(pyr, B, seed):
    zoom_max = max(b.zoom for b in pyr.bands)
    boxes, zs = random_viewports(pyr.lo, pyr.hi, zoom_max + 2, B, seed=seed)
    if B >= 3:       # corners: full extent, a point, wholly outside
        boxes[0] = np.concatenate([pyr.lo, pyr.hi])
        zs[0] = 0
        boxes[1] = np.concatenate([pyr.lo, pyr.lo])
        boxes[2] = np.concatenate([pyr.hi + 10, pyr.hi + 11])
    return boxes, zs


@pytest.mark.parametrize("B", [1, 3, 64])
def test_query_equals_jax_and_reference(pyramids, B):
    ref_pyr, pyr = pyramids
    boxes, zs = _viewports(pyr, B, seed=B)
    out = QueryEngine(pyr, device="cpu").query(boxes, zs)
    want = jax_serve.QueryEngine(ref_pyr).query(boxes, zs)
    assert set(out) == set(want)
    for k in want:
        assert out[k].dtype == want[k].dtype and out[k].shape == want[k].shape
        assert np.array_equal(_bits(out[k]), _bits(want[k])), k
    nonempty = 0
    for i in range(B):
        got = trim_result(out, i)
        oracle = reference_resolve(pyr, boxes[i], int(zs[i]))
        assert got["band"] == oracle["band"]
        assert got["covered"] == oracle["covered"]
        for k in ("vid", "rep", "inside", "eid", "tiles", "vpos", "epos",
                  "vmass"):
            assert got[k].shape == oracle[k].shape, (i, k)
            assert np.array_equal(_bits(got[k]), _bits(oracle[k])), (i, k)
        nonempty += len(got["vid"]) > 0
    assert nonempty >= B // 2


def test_cover_truncation_and_band_selection(pyramids):
    _, pyr = pyramids
    eng = QueryEngine(pyr, device="cpu")
    z_fine = pyr.bands[0].zoom
    box = np.concatenate([pyr.lo, pyr.hi]).astype(np.float32)
    got = trim_result(eng.query(box[None], np.asarray([z_fine + 1])), 0)
    assert got["covered"] == (1 << z_fine) ** 2 > MAX_TILES
    assert len(got["tiles"]) == MAX_TILES
    zs = np.asarray([b.zoom for b in pyr.bands])
    assert band_for_zoom(zs, np.asarray([0]))[0] == len(zs) - 1
    assert (np.diff(zs) < 0).all()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_store_cross_reads(pyramids, tmp_path, writer):
    """A pyramid written by either package loads in the other, the same
    shards, manifest and digest."""
    ref, pyr = pyramids
    a, b = str(tmp_path / "port"), str(tmp_path / "jax")
    save_pyramid(a, pyr)
    jax_serve.save_pyramid(b, ref)
    assert sorted(os.listdir(a)) == sorted(os.listdir(b))
    with open(os.path.join(a, "manifest.json")) as f, \
            open(os.path.join(b, "manifest.json")) as g:
        assert json.load(f) == json.load(g)
    path = a if writer == "port" else b
    loaded = (jax_serve.load_pyramid(path, validate=True) if writer == "port"
              else load_pyramid(path, validate=True))
    assert TileStore(path).verify()
    for x, y in zip(loaded.bands, pyr.bands):
        for f in BAND_FIELDS:
            assert np.array_equal(_bits(getattr(x, f)), _bits(getattr(y, f)))


def test_store_lru_and_empty_tiles(pyramids, tmp_path):
    _, pyr = pyramids
    path = str(tmp_path / "pyr")
    save_pyramid(path, pyr)
    store = TileStore(path, cache_tiles=4)
    G_ = 1 << store.band_meta(0)["zoom"]
    present = store._present[0]
    absent = next((tx, ty) for tx in range(G_) for ty in range(G_)
                  if (tx, ty) not in present)
    t = store.tile(0, *absent)
    assert (t["vid"] == -1).all() and t["count"][0] == 0
    some = sorted(present)[:6]
    for tx, ty in some:
        store.tile(0, tx, ty)
    assert len(store._cache) <= 4
    h0 = store.hits
    store.tile(0, *some[-1])
    assert store.hits == h0 + 1


def test_npz_bytes_and_digest_equal_jax(tmp_path, monkeypatch):
    """``save_npz`` writes the JAX package's bytes (zip entry times pinned:
    npz stamps the clock) and ``array_digest`` its digest."""
    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    rng = np.random.default_rng(0)
    arrays = {"vid": rng.integers(-1, 99, 64).astype(np.int32),
              "pos": rng.random((64, 2)).astype(np.float32),
              "count": np.asarray([5], np.int32),
              "big": rng.random(40000).astype(np.float32)}
    a, b = str(tmp_path / "a.npz"), str(tmp_path / "b.npz")
    ckpt.save_npz(a, arrays)
    jax_ckpt.save_npz(b, arrays)
    with open(a, "rb") as f, open(b, "rb") as g:
        assert f.read() == g.read()
    assert ckpt.array_digest(arrays) == jax_ckpt.array_digest(arrays)
    back = ckpt.load_npz(b)
    assert all(np.array_equal(back[k], arrays[k]) for k in arrays)


@pytest.mark.parametrize("n,G_,cap", [(500, 8, 16), (3000, 64, 4)])
def test_bin_vertices_box_equals_jax(n, G_, cap):
    """``bin_vertices(box=)``: cid, bucket and inb equal JAX's, points
    outside the box clipped to the border cells; one box serves every
    lane."""
    rng = np.random.default_rng(n)
    pos = (rng.standard_normal((n, 2)) * 3).astype(np.float32)
    pos[: n // 4] = np.round(pos[: n // 4])          # ties within cells
    vmask = rng.random(n) < 0.9
    lo, hi = np.float32([-2.5, -3.0]), np.float32([2.0, 4.5])
    want = jax_grid.bin_vertices(jnp.asarray(pos), jnp.asarray(vmask), G_,
                                 cap, box=(jnp.asarray(lo), jnp.asarray(hi)))
    t = lambda a: torch.from_numpy(a)
    box = (t(lo), t(hi))
    got = grid_ops.bin_vertices(t(pos), t(vmask), G_, cap, box=box)
    for x, y in zip(got, want):
        assert np.array_equal(x.numpy(), np.asarray(y))
    pos2 = np.roll(pos, 7, axis=0)
    lanes = grid_ops.bin_vertices(t(np.stack([pos, pos2])),
                                  t(np.stack([vmask, vmask])), G_, cap,
                                  box=box)
    one = grid_ops.bin_vertices(t(pos2), t(vmask), G_, cap, box=box)
    for x, y, z in zip(lanes, got, one):
        assert torch.equal(x[0], y) and torch.equal(x[1], z)


def test_grid_cell_size_numpy_twin():
    rng = np.random.default_rng(1)
    for _ in range(50):
        lo = (rng.standard_normal(2) * 100).astype(np.float32)
        hi = lo + (rng.random(2) * rng.choice([1e-9, 1e-3, 10.0, 1e4])
                   ).astype(np.float32)
        for G_ in (1, 3, 128, 256):
            a = grid_ops.grid_cell_size(lo, hi, G_)
            b = grid_ops.grid_cell_size(torch.from_numpy(lo),
                                        torch.from_numpy(hi), G_).numpy()
            c = np.asarray(jax_grid.grid_cell_size(jnp.asarray(lo),
                                                   jnp.asarray(hi), G_))
            assert a.dtype == np.float32
            assert np.array_equal(_bits(a), _bits(b))
            assert np.array_equal(_bits(a), _bits(c))


def test_micro_batcher_and_close(pyramids):
    _, pyr = pyramids
    eng = QueryEngine(pyr, device="cpu")
    zoom_max = max(b.zoom for b in pyr.bands)
    boxes, zs = random_viewports(pyr.lo, pyr.hi, zoom_max, 16, seed=5)
    mb = MicroBatcher(eng, max_batch=16, window_s=0.02)
    futs = [mb.submit(boxes[i], int(zs[i])) for i in range(16)]
    res = [f.result(timeout=60) for f in futs]
    mb.close()
    assert mb.requests == 16 and mb.batches <= 8
    for i in range(16):
        ref = reference_resolve(pyr, boxes[i], int(zs[i]))
        assert np.array_equal(res[i]["vid"], ref["vid"])
        assert np.array_equal(res[i]["eid"], ref["eid"])
    with pytest.raises(RuntimeError):
        mb.submit(boxes[0], 0)


def test_serve_cli_build_bench_and_smoke(tmp_path, capsys):
    """``launch/serve.py`` on the CPU: build a pyramid, then a closed-loop
    bench over it whose JSON names its rows and device, then the smoke
    (gnp(2000): build, save, load with validation, 16 batched queries)."""
    out, js = str(tmp_path / "pyr"), str(tmp_path / "bench.json")
    common = ["--device", "cpu", "--out", out, "--graph", "grid",
              "--args", "12", "12", "--coarsest-iters", "30",
              "--finest-iters", "10", "--tile-cap", "16", "--edge-cap", "16"]
    serve_cli.main(["--build"] + common)
    assert os.path.exists(os.path.join(out, "manifest.json"))
    rows = serve_cli.main(["--bench", "--batches", "1,4", "--reqs", "8",
                           "--json", js] + common)
    assert [r["batch"] for r in rows] == [1, 4]
    with open(js) as f:
        rec = json.load(f)
    assert rec["device"] == "cpu" and len(rec["rows"]) == 2
    assert "pyramid:" in capsys.readouterr().out
    serve_cli.main(["--smoke", "--device", "cpu"])
    assert "serve smoke OK: 16/16 non-empty" in capsys.readouterr().out
