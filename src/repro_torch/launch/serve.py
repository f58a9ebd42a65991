"""Layout serving CLI on the port — build a quadtree tile pyramid from a
layout run, benchmark batched viewport queries against it, or smoke-test
the stack: the JAX package's ``launch/serve.py``, on the card by default
(``--device cpu`` runs the plain PyTorch versions instead).

    # build: layout a graph, derive the pyramid, persist it
    PYTHONPATH=src python -m repro_torch.launch.serve --build \
        --graph delaunay --args 100000 --out results/serve/delaunay100k

    # bench: closed-loop load generator, p50/p99 latency + sustained QPS
    PYTHONPATH=src python -m repro_torch.launch.serve --bench \
        --out results/serve/delaunay100k --batches 1,16,64

    # smoke: tiny end-to-end build → save → load → batched queries
    PYTHONPATH=src python -m repro_torch.launch.serve --smoke

Bench results land as JSON under --json (default
results/serve/bench.json), with the device they ran on.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import numpy as np

from repro_torch.core import LayoutConfig, multigila_layout
from repro_torch.graphs import generators
from repro_torch.graphs.io import load_edgelist
from repro_torch.serve import (MicroBatcher, QueryEngine, build_pyramid,
                               load_pyramid, save_pyramid)
from repro_torch.serve.query import random_viewports


def _load_graph(args):
    if args.edgelist:
        edges, n = load_edgelist(args.edgelist)
        print(f"edgelist {args.edgelist}: n={n} m={len(edges)}")
    else:
        edges, n, gargs = generators.from_cli(args.graph, args.args)
        print(f"graph {args.graph}{gargs}: n={n} m={len(edges)}")
    return edges, n


def build(args) -> str:
    edges, n = _load_graph(args)
    cfg = LayoutConfig(engine=args.engine, seed=args.seed,
                       coarsest_iters=args.coarsest_iters,
                       finest_iters=args.finest_iters)
    t0 = time.perf_counter()
    pos, stats, exp = multigila_layout(edges, n, cfg, export=True,
                                       device=args.device)
    t_layout = time.perf_counter() - t0
    print(f"layout: levels={stats.levels} time={t_layout:.1f}s")
    t0 = time.perf_counter()
    pyr = build_pyramid(exp, tile_cap=args.tile_cap, edge_cap=args.edge_cap,
                        max_zoom=args.max_zoom, device=args.device)
    save_pyramid(args.out, pyr)
    t_build = time.perf_counter() - t0
    shards = len(os.listdir(args.out)) - 1   # minus manifest.json
    for b, band in enumerate(pyr.bands):
        occ = band.tile_count.sum() / max((band.tile_count > 0).sum(), 1)
        print(f"  band {b}: zoom {band.zoom} ({band.tiles_per_axis}^2 tiles) "
              f"n={band.n} m={band.m} mean-occ={occ:.1f} "
              f"overfull={(band.tile_total > band.tile_count).sum()}")
    print(f"pyramid: {shards} tile shards, built+saved in {t_build:.1f}s "
          f"→ {args.out}")
    return args.out


def bench(args) -> list[dict]:
    pyr = load_pyramid(args.out)
    eng = QueryEngine(pyr, device=args.device)
    zoom_max = max(b.zoom for b in pyr.bands)
    batches = [int(b) for b in args.batches.split(",")]
    eng.warmup(tuple(QueryEngine._bucket(b) for b in batches))
    rows = []
    for B in batches:
        boxes, zs = random_viewports(pyr.lo, pyr.hi, zoom_max,
                                     max(args.reqs, B), seed=args.seed)
        n_batches = len(boxes) // B
        lat = []
        t_start = time.perf_counter()
        for i in range(n_batches):
            t0 = time.perf_counter()
            eng.query(boxes[i * B:(i + 1) * B], zs[i * B:(i + 1) * B])
            lat.append(time.perf_counter() - t0)
        total = time.perf_counter() - t_start
        # closed loop: every request in a batch observes its batch's latency
        per_req = np.repeat(lat, B)
        row = {"batch": B, "requests": n_batches * B,
               "qps": n_batches * B / total,
               "p50_ms": float(np.percentile(per_req, 50) * 1e3),
               "p99_ms": float(np.percentile(per_req, 99) * 1e3)}
        rows.append(row)
        print(f"  B={B:3d}: {row['qps']:9.1f} qps   "
              f"p50 {row['p50_ms']:7.2f} ms   p99 {row['p99_ms']:7.2f} ms")
    if rows and len(rows) > 1:
        print(f"  batched speedup B={rows[-1]['batch']} vs B={rows[0]['batch']}: "
              f"{rows[-1]['qps'] / rows[0]['qps']:.1f}× qps")
    os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
    rec = {"pyramid": args.out, "device": str(eng.device),
           "bands": [{"zoom": b.zoom, "n": b.n, "m": b.m} for b in pyr.bands],
           "tile_cap": pyr.tile_cap, "edge_cap": pyr.edge_cap,
           "reqs": args.reqs, "rows": rows}
    with open(args.json, "w") as f:
        json.dump(rec, f, indent=1)
    print(f"wrote {args.json}")
    return rows


def smoke(args) -> None:
    """CI end-to-end: tiny build → save → load → 16 batched queries."""
    with tempfile.TemporaryDirectory() as d:
        args.out = os.path.join(d, "pyr")
        args.graph, args.args, args.edgelist = "gnp", [2000, 4.0], ""
        build(args)
        pyr = load_pyramid(args.out, validate=True)
        eng = QueryEngine(pyr, device=args.device)
        mb = MicroBatcher(eng, max_batch=16, window_s=0.01)
        zoom_max = max(b.zoom for b in pyr.bands)
        boxes, zs = random_viewports(pyr.lo, pyr.hi, zoom_max, 16,
                                     seed=args.seed)
        futs = [mb.submit(boxes[i], int(zs[i])) for i in range(16)]
        results = [f.result(timeout=60) for f in futs]
        mb.close()
        n_nonempty = sum(len(r["vid"]) > 0 for r in results)
        assert n_nonempty >= 12, f"only {n_nonempty}/16 queries returned data"
        assert any(len(r["eid"]) > 0 for r in results), "no edges served"
        print(f"serve smoke OK: {n_nonempty}/16 non-empty, "
              f"{mb.batches} device batch(es) for {mb.requests} requests")


def main(argv=None):
    ap = argparse.ArgumentParser()
    mode = ap.add_mutually_exclusive_group(required=True)
    mode.add_argument("--build", action="store_true")
    mode.add_argument("--bench", action="store_true")
    mode.add_argument("--smoke", action="store_true")
    ap.add_argument("--graph", default="gnp",
                    help="generator name from repro_torch.graphs.generators")
    ap.add_argument("--args", nargs="*", type=float, default=[2000, 4.0])
    ap.add_argument("--edgelist", default="",
                    help="edge-list/.mtx file instead of a generator")
    ap.add_argument("--engine", default="multigila")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the layout, the binning and the "
                         "queries (default cuda)")
    ap.add_argument("--out", default="results/serve/pyramid")
    ap.add_argument("--tile-cap", type=int, default=64)
    ap.add_argument("--edge-cap", type=int, default=96)
    ap.add_argument("--max-zoom", type=int, default=8)
    ap.add_argument("--coarsest-iters", type=int, default=300)
    ap.add_argument("--finest-iters", type=int, default=50)
    ap.add_argument("--batches", default="1,16,64")
    ap.add_argument("--reqs", type=int, default=512,
                    help="closed-loop requests per batch size")
    ap.add_argument("--json", default="results/serve/bench.json")
    args = ap.parse_args(argv)

    if args.build:
        return build(args)
    if args.bench:
        return bench(args)
    return smoke(args)


if __name__ == "__main__":
    main()
