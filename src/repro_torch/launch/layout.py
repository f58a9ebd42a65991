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

``--trace out.json`` records the run's spans (coarsening, placement,
refine dispatches, waves) as a Chrome/Perfetto trace-event file.

``--driver multigila_dist --mesh DxM`` refines every level with the sharded
superstep over a D×M mesh of ``torch.distributed`` ranks: on the card a
one-rank mesh,

    python -m repro_torch.launch.layout --driver multigila_dist --mesh 1x1

and on the CPU as many gloo ranks as the mesh has,

    torchrun --nproc-per-node 8 -m repro_torch.launch.layout \
        --driver multigila_dist --mesh 4x2 --device cpu

Every rank lays out the graph; rank 0 prints and writes the outputs. A mesh
whose size is not the world size is an error.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch.distributed as dist

from repro_torch.core import (LayoutConfig, multigila_layout,
                              multigila_layout_many)
from repro_torch.graphs import generators
from repro_torch.graphs.graph import build_graph
from repro_torch.graphs.io import save_svg
from repro_torch.graphs.metrics import quality_report
from repro_torch.launch import mesh as mesh_mod
from repro_torch.obs import trace as obs_trace


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
                    help="write a Chrome/Perfetto trace of the run")
    ap.add_argument("--mesh", default="",
                    help="multigila_dist mesh as DATAxMODEL, e.g. 4x2 "
                         "(default: one mesh over every rank)")
    args = ap.parse_args(argv)
    mesh_mod.init_from_env(args.device)
    # under torchrun every rank runs this; rank 0 alone prints and writes
    rank0 = not dist.is_initialized() or dist.get_rank() == 0
    say = print if rank0 else (lambda *a, **k: None)
    if args.trace:
        obs_trace.enable()

    edges, n, gargs = generators.from_cli(args.graph, args.args)
    say(f"graph {args.graph}{gargs}: n={n} m={len(edges)}")

    mesh_shape = (tuple(int(s) for s in args.mesh.lower().split("x"))
                  if args.mesh else None)
    cfg = LayoutConfig(engine=args.engine, seed=args.seed,
                       mesh_shape=mesh_shape)
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
        say(f"batched: {B} layouts in {dt:.2f}s = {B / dt:.2f} graphs/s "
              f"(levels={outs[0][1].levels})")
        if args.many_compare:
            t0 = time.perf_counter()
            seq = [multigila_layout(e, nn, dataclasses.replace(cfg, seed=s),
                                    device=args.device)
                   for (e, nn), s in zip(reqs, seeds)]
            ds = time.perf_counter() - t0
            same = all(np.array_equal(a[0], b[0]) for a, b in zip(seq, outs))
            say(f"sequential: {ds:.2f}s = {B / ds:.2f} graphs/s → "
                  f"batched speedup {ds / dt:.2f}x, bit-identical={same}")
        pos, stats = outs[0]
    else:
        t0 = time.perf_counter()
        pos, stats = multigila_layout(edges, n, cfg, device=args.device)
        dt = time.perf_counter() - t0
        say(f"levels={stats.levels} sizes={stats.level_sizes} "
              f"time={dt:.2f}s")

    g = build_graph(edges, n, device="cpu")
    rep = quality_report(g, np.pad(pos, ((0, g.n_pad - n), (0, 0))),
                         max_cre_edges=0 if args.no_cre else 40000)
    say(f"CRE={rep['cre']:.3f} NELD={rep['neld']:.3f} "
          f"stress={rep['stress']:.4f}")
    if args.svg and rank0:
        save_svg(args.svg, pos, edges)
        say(f"wrote {args.svg}")
    if args.trace and rank0:
        obs_trace.export(args.trace)
        say(f"wrote trace to {args.trace} "
              f"({len(obs_trace.get_tracer())} events)")
    return rep


if __name__ == "__main__":
    try:
        main()
    finally:
        mesh_mod.shutdown()
