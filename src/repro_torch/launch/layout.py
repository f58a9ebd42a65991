"""End-to-end Multi-GiLA driver (the paper's pipeline) on the port.

    PYTHONPATH=src python -m repro_torch.launch.layout --graph grid \
        --args 40 40 --engine stress --svg /tmp/grid.svg

Runs pruning → coarsening → placement/refinement → reinsertion on the card
(``--device cpu`` runs the plain PyTorch versions of the kernels instead),
reports the paper's quality metrics (CRE, NELD) and the wall time, and
optionally writes an SVG: the JAX package's ``launch/layout.py``.

``--many B`` instead lays out B seed-varied requests of the graph through
the batched multi-graph driver (``multigila_layout_many``) and reports
graphs/s; ``--many-compare`` also runs the sequential driver over the same
requests and reports whether every graph came out bit-identical (on the
CPU it does; on the card the sequential driver sums edges with atomics).

Not ported yet, and refused: ``--trace`` (observability, ROADMAP.md queue
1, item 10) and ``--mesh`` (the sharded driver, item 11).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core import (LayoutConfig, multigila_layout,
                              multigila_layout_many)
from repro_torch.graphs import generators
from repro_torch.graphs.graph import build_graph
from repro_torch.graphs.io import save_svg
from repro_torch.graphs.metrics import quality_report

_UNPORTED = (("trace", "--trace", 10), ("mesh", "--mesh", 11))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="grid",
                    help="generator name from repro_torch.graphs.generators")
    ap.add_argument("--args", nargs="*", type=float, default=[20, 20])
    ap.add_argument("--engine", default="multigila",
                    choices=["multigila", "multigila_dist", "centralized",
                             "flat", "gila", "stress"],
                    help="refinement engine (gila | stress); the driver "
                         "names stay accepted and select --driver instead "
                         "(LayoutConfig shim)")
    ap.add_argument("--driver", default=None,
                    choices=["multigila", "multigila_dist", "centralized",
                             "flat"],
                    help="hierarchy driver (default multigila)")
    ap.add_argument("--device", default="cuda",
                    help="torch device of the layout (default cuda)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--svg", default="")
    ap.add_argument("--no-cre", action="store_true")
    ap.add_argument("--many", type=int, default=0, metavar="B",
                    help="lay out B seed-varied requests through the "
                         "batched multi-graph driver")
    ap.add_argument("--many-compare", action="store_true",
                    help="with --many: also run the sequential driver and "
                         "check per-graph bit-identity")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="not ported yet (span tracer)")
    ap.add_argument("--mesh", default="",
                    help="not ported yet (sharded driver)")
    args = ap.parse_args(argv)
    for attr, flag, item in _UNPORTED:
        if getattr(args, attr):
            raise NotImplementedError(
                f"{flag} is not ported yet: ROADMAP.md queue 1, item {item}")

    edges, n, gargs = generators.from_cli(args.graph, args.args)
    print(f"graph {args.graph}{gargs}: n={n} m={len(edges)}")

    cfg = LayoutConfig(engine=args.engine, seed=args.seed)
    if args.driver is not None:
        cfg = dataclasses.replace(cfg, driver=args.driver)

    if args.many > 0:
        B = args.many
        seeds = [args.seed + i for i in range(B)]
        reqs = [(edges, n)] * B
        t0 = time.perf_counter()
        outs = multigila_layout_many(reqs, cfg, seeds=seeds,
                                     device=args.device)
        dt = time.perf_counter() - t0
        print(f"batched: {B} layouts in {dt:.2f}s = {B / dt:.2f} graphs/s "
              f"(levels={outs[0][1].levels})")
        if args.many_compare:
            t0 = time.perf_counter()
            seq = [multigila_layout(e, nn, dataclasses.replace(cfg, seed=s),
                                    device=args.device)
                   for (e, nn), s in zip(reqs, seeds)]
            ds = time.perf_counter() - t0
            same = all(np.array_equal(a[0], b[0]) for a, b in zip(seq, outs))
            print(f"sequential: {ds:.2f}s = {B / ds:.2f} graphs/s → "
                  f"batched speedup {ds / dt:.2f}x, bit-identical={same}")
        pos, stats = outs[0]
    else:
        t0 = time.perf_counter()
        pos, stats = multigila_layout(edges, n, cfg, device=args.device)
        dt = time.perf_counter() - t0
        print(f"levels={stats.levels} sizes={stats.level_sizes} "
              f"time={dt:.2f}s")

    g = build_graph(edges, n, device="cpu")
    rep = quality_report(g, np.pad(pos, ((0, g.n_pad - n), (0, 0))),
                         max_cre_edges=0 if args.no_cre else 40000)
    print(f"CRE={rep['cre']:.3f} NELD={rep['neld']:.3f} "
          f"stress={rep['stress']:.4f}")
    if args.svg:
        save_svg(args.svg, pos, edges)
        print(f"wrote {args.svg}")
    return rep


if __name__ == "__main__":
    main()
