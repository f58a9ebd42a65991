"""End-to-end Multi-GiLA driver (the paper's pipeline) on the port.

    PYTHONPATH=src python -m repro_torch.launch.layout --graph grid \
        --args 40 40 --engine stress --svg /tmp/grid.svg

Runs pruning → coarsening → placement/refinement → reinsertion on the card
(``--device cpu`` runs the plain PyTorch versions of the kernels instead),
reports the paper's quality metrics (CRE, NELD) and the wall time, and
optionally writes an SVG: the JAX package's ``launch/layout.py``.

Not ported yet, and refused: ``--many``/``--many-compare`` (the batched
driver, ROADMAP.md queue 1, item 9), ``--trace`` (observability, item 10)
and ``--mesh`` (the sharded driver, item 11).
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

from repro_torch.core import LayoutConfig, multigila_layout
from repro_torch.graphs import generators
from repro_torch.graphs.graph import build_graph
from repro_torch.graphs.io import save_svg
from repro_torch.graphs.metrics import quality_report

_UNPORTED = (("many", "--many", 9), ("many_compare", "--many-compare", 9),
             ("trace", "--trace", 10), ("mesh", "--mesh", 11))


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
                    help="not ported yet (batched driver)")
    ap.add_argument("--many-compare", action="store_true",
                    help="not ported yet (batched driver)")
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

    t0 = time.perf_counter()
    pos, stats = multigila_layout(edges, n, cfg, device=args.device)
    dt = time.perf_counter() - t0
    print(f"levels={stats.levels} sizes={stats.level_sizes} time={dt:.2f}s")

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
