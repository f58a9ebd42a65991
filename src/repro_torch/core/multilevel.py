"""Multi-GiLA — the full multilevel pipeline (paper §3.1), on torch.

pruning → coarsening* → coarsest layout → [placement → single-level
refinement]* → reinsertion, applied per connected component, components
packed on a shelf grid at the end: the JAX package's ``core/multilevel.py``.
Host work (pruning, components, k-hop lists, reinsertion) stays numpy; the
hierarchy, placement and refinement run on ``device`` (default: the card).

The same pipeline powers three DRIVERS (``LayoutConfig.driver``):
  * ``multigila``   — the paper's algorithm;
  * ``centralized`` — FM³ stand-in baseline: the same hierarchy, exact
                      all-pairs repulsion at every level;
  * ``flat``        — single-level GiLA baseline (the paper's predecessor):
                      no pruning, no hierarchy, one level from a random
                      init.
The JAX package's fourth, ``multigila_dist`` (the sharded superstep), is
not ported yet. Orthogonally, ``LayoutConfig.engine`` selects the
per-level refinement engine (core/engine.py): ``"gila"`` —
Fruchterman–Reingold forces — or ``"stress"`` — maxent-stress
(core/stress.py). ``LayoutConfig.bucketing`` (default True) pads every level
to pow2 shape buckets and refines it through the process-wide cache of
captured step programs (core/bucketing.py); False is the JAX package's
exact-shape path: round-256 padding, host compaction
(``solar_merger.next_level_host``) and the engine's eager ``refine`` loop.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core import bucketing, gila
from repro_torch.core.engine import get_engine
from repro_torch.core.pruning import prune_degree_one, reinsert
from repro_torch.core.schedule import LevelSchedule, make_schedule
from repro_torch.core.solar_merger import LevelInfo, next_level, run_merger
from repro_torch.core.solar_placer import solar_placer
from repro_torch.graphs.graph import PaddedGraph, build_graph
from repro_torch.utils.device import resolve_device, synchronize


_DRIVERS = ("multigila", "multigila_dist", "centralized", "flat")


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
    driver: str = "multigila"        # multigila | centralized | flat
    engine: str = "gila"             # per-level refinement engine: gila | stress
    prune: bool = True               # degree-one pruning (never under flat)
    # pow2 shape buckets + the cache of captured refine steps
    # (core/bucketing.py); False = exact shapes and the eager refine loop
    bucketing: bool = True

    def __post_init__(self):
        # the JAX package's shim: ``engine=`` used to name the DRIVER; a
        # driver name passed there selects the driver and leaves the engine
        # at gila (frozen dataclass, so rebind via object.__setattr__)
        if self.engine in _DRIVERS:
            object.__setattr__(self, "driver", self.engine)
            object.__setattr__(self, "engine", "gila")


@dataclasses.dataclass
class LayoutStats:
    levels: int = 0
    level_sizes: tuple = ()          # ((n, m), ...) finest first
    level_modes: tuple = ()          # repulsion mode per level, finest first
    #: wall-clock seconds per phase (coarsen / place / refine / compile),
    #: each phase ended by a device synchronize; coarsen includes the input
    #: graph's build, which is all it holds under the flat driver; compile
    #: is the warm-up iteration and CUDA-graph capture of each cold step
    #: program (core/bucketing.py), 0 on the CPU and when every bucket is
    #: warm
    phase_seconds: dict = dataclasses.field(
        default_factory=lambda: {"coarsen": 0.0, "place": 0.0,
                                 "refine": 0.0, "compile": 0.0})


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
    if cfg.driver == "multigila_dist":
        raise NotImplementedError(
            "driver 'multigila_dist' (the sharded path) is not ported yet: "
            "ROADMAP.md queue 1, item 11")
    if cfg.driver not in _DRIVERS:
        raise ValueError(f"unknown driver {cfg.driver!r}; known: "
                         f"{list(_DRIVERS)}")
    get_engine(cfg.engine)                  # ValueError for an unknown one


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
        cg, info = next_level(g, st, bucket=cfg.bucketing)
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
    """Level i of L; the centralized driver lifts the exact threshold."""
    exact = 10 ** 9 if cfg.driver == "centralized" else cfg.exact_threshold
    return make_schedule(i, L, g.n, g.m, exact_threshold=exact,
                         grid_threshold=cfg.grid_threshold,
                         coarsest_iters=cfg.coarsest_iters,
                         finest_iters=cfg.finest_iters,
                         ideal_len=cfg.ideal_len, n_pad=g.n_pad,
                         engine=cfg.engine)


def _refine(stats: LayoutStats, device, cfg: LayoutConfig, g: PaddedGraph,
            pos, sched: LevelSchedule, seed: int) -> torch.Tensor:
    """One level's refinement: the cached step program of its bucket, or,
    with ``cfg.bucketing`` off, the engine's eager loop."""
    if cfg.bucketing:
        return bucketing.refine_level(g, pos, sched, ideal_len=cfg.ideal_len,
                                      rep_const=cfg.rep_const, seed=seed,
                                      phases=stats.phase_seconds)
    with _phase(stats, device, "refine"):
        eng = get_engine(sched.engine)
        nbr_idx, nbr_mask = eng.init_state(g, sched, seed)
        return eng.refine(g, pos, nbr_idx, nbr_mask, sched,
                          ideal_len=cfg.ideal_len, rep_const=cfg.rep_const)


def layout_component(edges: np.ndarray, n: int, cfg: LayoutConfig, *,
                     weights=None, device=None):
    """Multi-GiLA on one connected component → (pos float32[n, 2] on the
    host, LayoutStats).

    ``weights`` (float[m], optional) are per-edge weights: the attraction
    term's ideal length ℓ_e = w_e·L, and the stress engine's target
    distances. They thread prune → build_graph → hierarchy (the solar
    merger compounds them into coarse ``ewt``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    stats = LayoutStats()
    if n == 1:
        return np.zeros((1, 2), np.float32), stats
    pr = (prune_degree_one(edges, n, weights=weights)
          if cfg.prune and cfg.driver != "flat" else None)
    if pr is not None:
        work_edges, work_n, mass, work_ewt = pr.edges, pr.n, pr.mass, pr.ewt
    else:
        work_edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        work_n, mass, work_ewt = n, None, weights
    if work_n == 0 or len(work_edges) == 0:
        # star graphs collapse entirely under pruning: lay out leaves only
        pos = (reinsert(pr, np.zeros((max(work_n, 1), 2), np.float32),
                        work_edges)
               if pr is not None else np.zeros((n, 2), np.float32))
        return pos, stats

    with _phase(stats, dev, "coarsen"):
        g0 = build_graph(work_edges, work_n, mass=mass, ewt=work_ewt,
                         bucket=cfg.bucketing, device=dev)
        graphs, infos = ([g0], []) if cfg.driver == "flat" else \
            build_hierarchy(g0, cfg, device=dev)
    L = len(graphs)
    scheds = [_schedule(cfg, i, L, g) for i, g in enumerate(graphs)]
    stats.levels = L
    stats.level_sizes = tuple((g.n, g.m) for g in graphs)
    stats.level_modes = tuple(s.mode for s in scheds)

    # coarsest level (flat: the only one): random init + layout
    gk = graphs[-1]
    with _phase(stats, dev, "refine"):
        pos = gila.random_init(gk, cfg.ideal_len * max(gk.n, 4) ** 0.5,
                               cfg.seed)
    pos = _refine(stats, dev, cfg, gk, pos, scheds[-1],
                  cfg.seed if cfg.driver == "flat" else cfg.seed + L)

    # walk the hierarchy back down: place, then refine
    for i in range(L - 2, -1, -1):
        gi = graphs[i]
        with _phase(stats, dev, "place"):
            pos = solar_placer(gi, infos[i], pos, seed=cfg.seed + i,
                               scatter_scale=0.5 * cfg.ideal_len)
        pos = _refine(stats, dev, cfg, gi, pos, scheds[i], cfg.seed + i)

    pos = pos.cpu().numpy().astype(np.float32)[: g0.n]
    return (reinsert(pr, pos, work_edges) if pr is not None else pos), stats


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
                     cfg: LayoutConfig | None = None, *, weights=None,
                     device=None):
    """Full pipeline on a possibly-disconnected graph → (pos float32[n, 2]
    on the host, LayoutStats). ``weights`` (float[m], optional) are the
    per-edge weights (see ``layout_component``). ``device=None`` means the
    card; with no card present the call raises."""
    cfg = cfg or LayoutConfig()
    _check_supported(cfg)
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if weights is not None:
        weights = np.asarray(weights, np.float32).reshape(-1)
        if len(weights) != len(edges):
            raise ValueError(f"{len(weights)} weights for {len(edges)} edges")
    labels = connected_components(edges, n)
    comps = np.unique(labels)
    if len(comps) == 1:
        return layout_component(edges, n, cfg, weights=weights, device=dev)

    stats = LayoutStats()
    layouts, index_maps = [], []
    for c in comps:
        vs = np.nonzero(labels == c)[0]
        remap = np.full(n, -1, np.int64)
        remap[vs] = np.arange(vs.size)
        emask = labels[edges[:, 0]] == c
        ce = np.stack([remap[edges[emask, 0]], remap[edges[emask, 1]]], 1)
        cw = weights[emask] if weights is not None else None
        p, s = layout_component(ce, vs.size, cfg, weights=cw, device=dev)
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
