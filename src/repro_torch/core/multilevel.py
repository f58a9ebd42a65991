"""Multi-GiLA — the full multilevel pipeline (paper §3.1), on torch.

pruning → coarsening* → coarsest layout → [placement → single-level
refinement]* → reinsertion, applied per connected component, components
packed on a shelf grid at the end. This is the JAX package's
``core/multilevel.py`` main path: driver ``multigila``, engine ``gila``.
Host work (pruning, components, k-hop lists, reinsertion) stays numpy; the
hierarchy, placement and refinement run on ``device`` (default: the card).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import bucketing, gila
from repro_torch.core.pruning import prune_degree_one, reinsert
from repro_torch.core.schedule import LevelSchedule, make_schedule
from repro_torch.core.solar_merger import LevelInfo, next_level, run_merger
from repro_torch.core.solar_placer import solar_placer
from repro_torch.graphs.graph import PaddedGraph, build_graph
from repro_torch.utils.device import resolve_device, synchronize


@dataclasses.dataclass(frozen=True)
class LayoutConfig:
    coarsest_threshold: int = 50     # halt coarsening below this many vertices
    max_levels: int = 24
    min_shrink: float = 0.96         # stop if a level shrinks less than this
    p_sun: float = 0.35
    exact_threshold: int = 2048      # exact N-body up to this size
    grid_threshold: int = 32768      # grid-approx repulsion above this size
    coarsest_iters: int = 300
    finest_iters: int = 50
    ideal_len: float = 1.0
    rep_const: float = 1.0
    seed: int = 0
    driver: str = "multigila"        # only "multigila" is ported
    engine: str = "gila"             # only "gila" is ported


@dataclasses.dataclass
class LayoutStats:
    levels: int = 0
    level_sizes: tuple = ()          # ((n, m), ...) finest first
    level_modes: tuple = ()          # repulsion mode per level, finest first
    #: wall-clock seconds per phase (coarsen / place / refine), each phase
    #: ended by a device synchronize
    phase_seconds: dict = dataclasses.field(
        default_factory=lambda: {"coarsen": 0.0, "place": 0.0,
                                 "refine": 0.0})


def connected_components(edges: np.ndarray, n: int) -> np.ndarray:
    """Component labels, label = minimum vertex id in the component."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components as _cc

    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if n <= 0:
        return np.zeros((0,), dtype=np.int64)
    if len(edges) == 0:
        return np.arange(n, dtype=np.int64)
    a = coo_matrix((np.ones(len(edges), np.int8),
                    (edges[:, 0], edges[:, 1])), shape=(n, n))
    _, comp = _cc(a, directed=False)
    first = np.full(int(comp.max()) + 1, n, dtype=np.int64)
    np.minimum.at(first, comp, np.arange(n, dtype=np.int64))
    return first[comp]


def _check_supported(cfg: LayoutConfig) -> None:
    if cfg.driver != "multigila":
        raise NotImplementedError(
            f"driver {cfg.driver!r}: only 'multigila' is ported")
    if cfg.engine != "gila":
        raise NotImplementedError(
            f"engine {cfg.engine!r}: only 'gila' is ported")


def build_hierarchy(g0: PaddedGraph, cfg: LayoutConfig, *, device=None
                    ) -> tuple[list[PaddedGraph], list[LevelInfo]]:
    """Coarsening loop: repeated Distributed Solar Merger applications.

    When the shrink-ratio break fires, the final merger's coarse graph and
    its ``LevelInfo`` are both discarded, so ``len(graphs) == len(infos) + 1``.
    """
    dev = resolve_device(device)
    if g0.device != dev:
        raise ValueError(f"graph on {g0.device}, expected {dev}")
    graphs, infos = [g0], []
    g = g0
    for lvl in range(cfg.max_levels):
        if g.n <= cfg.coarsest_threshold:
            break
        st = run_merger(g, p_sun=cfg.p_sun, seed=cfg.seed + 101 * lvl)
        cg, info = next_level(g, st)
        if cg.n >= g.n * cfg.min_shrink or cg.n < 1:
            break
        graphs.append(cg)
        infos.append(info)
        g = cg
    return graphs, infos


@contextlib.contextmanager
def _phase(stats: LayoutStats, device: torch.device, name: str):
    """Add the block's wall-clock seconds to ``stats.phase_seconds[name]``;
    the phase ends with a device synchronize so queued kernels count in it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        synchronize(device)
        stats.phase_seconds[name] += time.perf_counter() - t0


def _schedule(cfg: LayoutConfig, i: int, L: int, g: PaddedGraph
              ) -> LevelSchedule:
    return make_schedule(i, L, g.n, g.m, exact_threshold=cfg.exact_threshold,
                         grid_threshold=cfg.grid_threshold,
                         coarsest_iters=cfg.coarsest_iters,
                         finest_iters=cfg.finest_iters,
                         ideal_len=cfg.ideal_len, n_pad=g.n_pad)


def layout_component(edges: np.ndarray, n: int, cfg: LayoutConfig, *,
                     device=None):
    """Multi-GiLA on one connected component → (pos float32[n, 2] on the
    host, LayoutStats)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    stats = LayoutStats()
    if n == 1:
        return np.zeros((1, 2), np.float32), stats
    pr = prune_degree_one(edges, n)
    if pr.n == 0 or len(pr.edges) == 0:
        # star graphs collapse entirely under pruning: lay out leaves only
        return reinsert(pr, np.zeros((max(pr.n, 1), 2), np.float32),
                        pr.edges), stats

    with _phase(stats, dev, "coarsen"):
        g0 = build_graph(pr.edges, pr.n, mass=pr.mass, bucket=True,
                         device=dev)
        graphs, infos = build_hierarchy(g0, cfg, device=dev)
    L = len(graphs)
    scheds = [_schedule(cfg, i, L, g) for i, g in enumerate(graphs)]
    stats.levels = L
    stats.level_sizes = tuple((g.n, g.m) for g in graphs)
    stats.level_modes = tuple(s.mode for s in scheds)

    # coarsest level: random init + layout
    gk = graphs[-1]
    with _phase(stats, dev, "refine"):
        pos = gila.random_init(gk, cfg.ideal_len * max(gk.n, 4) ** 0.5,
                               cfg.seed)
        pos = bucketing.refine_level(gk, pos, scheds[-1],
                                     ideal_len=cfg.ideal_len,
                                     rep_const=cfg.rep_const,
                                     seed=cfg.seed + L)

    # walk the hierarchy back down: place, then refine
    for i in range(L - 2, -1, -1):
        gi = graphs[i]
        with _phase(stats, dev, "place"):
            pos = solar_placer(gi, infos[i], pos, seed=cfg.seed + i,
                               scatter_scale=0.5 * cfg.ideal_len)
        with _phase(stats, dev, "refine"):
            pos = bucketing.refine_level(gi, pos, scheds[i],
                                         ideal_len=cfg.ideal_len,
                                         rep_const=cfg.rep_const,
                                         seed=cfg.seed + i)

    pos = pos.cpu().numpy().astype(np.float32)[: g0.n]
    return reinsert(pr, pos, pr.edges), stats


def _pack_components(layouts: list[np.ndarray], pad: float = 2.0) -> list:
    """Shelf-pack component bounding boxes into a near-square arrangement."""
    boxes = []
    for P in layouts:
        lo = P.min(axis=0) if len(P) else np.zeros(2)
        hi = P.max(axis=0) if len(P) else np.zeros(2)
        boxes.append((P - lo, hi - lo + pad))
    order = np.argsort([-(b[1][0] * b[1][1]) for b in boxes])
    total_area = sum(float(b[1][0] * b[1][1]) for b in boxes)
    shelf_w = max(total_area ** 0.5, max(float(b[1][0]) for b in boxes))
    out = [None] * len(boxes)
    x = y = shelf_h = 0.0
    for oi in order:
        P, wh = boxes[oi]
        if x + wh[0] > shelf_w and x > 0:
            y += shelf_h
            x = shelf_h = 0.0
        out[oi] = P + np.array([x, y], np.float32)
        x += float(wh[0])
        shelf_h = max(shelf_h, float(wh[1]))
    return out


def multigila_layout(edges: np.ndarray, n: int,
                     cfg: LayoutConfig | None = None, *, device=None):
    """Full pipeline on a possibly-disconnected graph → (pos float32[n, 2]
    on the host, LayoutStats). ``device=None`` means the card; with no card
    present the call raises."""
    cfg = cfg or LayoutConfig()
    _check_supported(cfg)
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    labels = connected_components(edges, n)
    comps = np.unique(labels)
    if len(comps) == 1:
        return layout_component(edges, n, cfg, device=dev)

    stats = LayoutStats()
    layouts, index_maps = [], []
    for c in comps:
        vs = np.nonzero(labels == c)[0]
        remap = np.full(n, -1, np.int64)
        remap[vs] = np.arange(vs.size)
        emask = labels[edges[:, 0]] == c
        ce = np.stack([remap[edges[emask, 0]], remap[edges[emask, 1]]], 1)
        p, s = layout_component(ce, vs.size, cfg, device=dev)
        stats.levels = max(stats.levels, s.levels)
        for k, v in s.phase_seconds.items():
            stats.phase_seconds[k] += v
        layouts.append(np.asarray(p))
        index_maps.append(vs)
    packed = _pack_components(layouts)
    pos = np.zeros((n, 2), np.float32)
    for vs, P in zip(index_maps, packed):
        pos[vs] = P
    return pos, stats
