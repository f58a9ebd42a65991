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

``multigila_layout_many`` lays out many graphs at once: a ``WaveScheduler``
walks every component's hierarchy (``_ComponentTask``, the pipeline that
``layout_component`` walks too) one level a wave, and runs each wave's
refinements grouped by shape bucket as batched programs
(``bucketing.refine_level_many``); each graph's result equals its
``multigila_layout`` call's.

``multigila_layout(..., export=True)`` also returns the hierarchy as the
serving layer consumes it (``HierarchyExport``: per level its edges, the
parent map into the next coarser level and each vertex's level-0
representative; numpy on the host). Observability, as in the JAX package:
``coarsen``, ``place`` and ``refine.level`` spans of the process tracer,
the wave scheduler's ``wave``, ``refine.group`` and ``refine`` spans and
``wave.straggler`` instants on its own tracer, and the wave-composition
metric families; the phase seconds also feed
``gila_phase_seconds_total``.
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
from repro_torch.graphs.graph import PaddedGraph, build_graph, unique_edges
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.clock import Clock, SystemClock
from repro_torch.utils.device import resolve_device, synchronize
from repro_torch.utils.timing import StepTimer


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
    #: warm. Under ``multigila_layout_many`` a graph's refine and compile
    #: are its lanes' shares of the group dispatches they rode in (a
    #: group's seconds over its lanes), so the graphs' sums are the run's
    phase_seconds: dict = dataclasses.field(
        default_factory=lambda: {"coarsen": 0.0, "place": 0.0,
                                 "refine": 0.0, "compile": 0.0})


@dataclasses.dataclass
class LevelExport:
    """One level of the hierarchy, as the serving layer consumes it.

    Level 0 is the FULL input graph (pruned leaves reinserted); levels
    1..L-1 are the solar-merger coarse graphs. ``parent[v]`` is v's vertex
    in the next coarser level (None at the coarsest); ``rep[v]`` is the
    level-0 vertex id of the system sun v collapses to, chained down the
    hierarchy, so coarse vertices stay addressable in input-graph terms.
    """
    n: int
    edges: np.ndarray            # int64[m, 2] — unique undirected, level-local
    parent: np.ndarray | None    # int32[n] — index into the next coarser level
    rep: np.ndarray              # int64[n] — representative level-0 vertex id


@dataclasses.dataclass
class HierarchyExport:
    """Per-level structure of a finished layout (serve/tiles.py's input).

    ``pos`` holds the final positions of level 0 only; coarse-level
    positions are derived (mass-weighted member centroids,
    ``serve.tiles.band_positions``), so every zoom band of the tile pyramid
    agrees with the drawing the user gets.
    """
    levels: list            # list[LevelExport], levels[0] = finest
    pos: np.ndarray         # float32[levels[0].n, 2]


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
    """Add the block's wall-clock seconds to ``stats.phase_seconds[name]``
    (and to ``gila_phase_seconds_total``); the phase ends with a device
    synchronize so queued kernels count in it."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        synchronize(device)
        bucketing.add_phase(stats.phase_seconds, name,
                            time.perf_counter() - t0)


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
                     export: bool = False, weights=None, device=None):
    """Multi-GiLA on one connected component → (pos float32[n, 2] on the
    host, LayoutStats), and with ``export=True`` the ``HierarchyExport`` as
    a third item: a ``_ComponentTask`` walked level by level, each level
    refined on its own (``_refine``).

    ``weights`` (float[m], optional) are per-edge weights: the attraction
    term's ideal length ℓ_e = w_e·L, and the stress engine's target
    distances. They thread prune → build_graph → hierarchy (the solar
    merger compounds them into coarse ``ewt``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    task = _ComponentTask(edges, n, cfg, device=dev, weights=weights)
    while not task.done:
        i, g, pos, sched, seed = task.next_level()
        with obs_trace.span("refine.level", level=i, n=g.n):
            task.feed(_refine(task.stats, dev, cfg, g, pos, sched, seed))
    if not export:
        return task.final, task.stats
    return task.final, task.stats, task.export(edges)


def _single_level_export(edges: np.ndarray, n: int, pos: np.ndarray
                         ) -> HierarchyExport:
    lvl = LevelExport(n=n, edges=np.asarray(edges, np.int64).reshape(-1, 2),
                      parent=None, rep=np.arange(n, dtype=np.int64))
    return HierarchyExport(levels=[lvl], pos=np.asarray(pos, np.float32))


def _input_to_work(pr, n: int) -> np.ndarray:
    """int64[n]: input vertex → work-graph (pruned) vertex. Leaf hosts are
    always kept (a host had degree ≥ 2, or is the kept end of a K2), so one
    indirection suffices."""
    if pr is None:
        return np.arange(n, dtype=np.int64)
    m = np.full(n, -1, np.int64)
    m[pr.old_of_new] = np.arange(pr.n)
    m[pr.leaves] = m[pr.leaf_host]
    return m


def _build_export(edges, n, pr, graphs, infos, pos_full) -> HierarchyExport:
    """The per-level export of one component (see ``HierarchyExport``),
    read to the host from its hierarchy (``graphs``, ``infos`` on any
    device)."""
    L = len(graphs)
    if L <= 1:
        return _single_level_export(edges, n, pos_full)
    host = lambda t: t.cpu().numpy()
    w_of_in = _input_to_work(pr, n)
    work_parent = host(infos[0].parent_coarse)[: graphs[0].n]
    rep_work = (pr.old_of_new if pr is not None
                else np.arange(n, dtype=np.int64))
    levels = [LevelExport(n=n, edges=np.asarray(edges, np.int64).reshape(-1, 2),
                          parent=work_parent[w_of_in].astype(np.int32),
                          rep=np.arange(n, dtype=np.int64))]
    rep = rep_work
    for i in range(1, L):
        gi = graphs[i]
        rep = rep[host(infos[i - 1].sun_pos_index)]
        parent = (host(infos[i].parent_coarse)[: gi.n].astype(np.int32)
                  if i < L - 1 else None)
        levels.append(LevelExport(n=gi.n, edges=unique_edges(gi),
                                  parent=parent, rep=rep.astype(np.int64)))
    return HierarchyExport(levels=levels, pos=np.asarray(pos_full, np.float32))


def _merge_exports(exports: list, index_maps: list, edges: np.ndarray,
                   n: int, pos: np.ndarray) -> HierarchyExport:
    """Merge per-component hierarchies into global zoom bands.

    Band 0 keeps the ORIGINAL global vertex ids (level-0 positions are the
    final packed drawing). Band b unions, from every component, its level
    ``min(b, L_c-1)``: a component whose hierarchy is shallower than b
    keeps contributing its coarsest level with an identity parent map, so
    every band is a complete drawing of the whole graph.
    """
    n_bands = max(len(e.levels) for e in exports)
    if n_bands == 1:
        return _single_level_export(edges, n, pos)

    # per (band, component) offsets of the merged index space (band 0 is the
    # identity on global ids, so offsets start at band 1)
    offs = []
    for b in range(1, n_bands):
        sizes = [e.levels[min(b, len(e.levels) - 1)].n for e in exports]
        offs.append(np.concatenate([[0], np.cumsum(sizes[:-1])]).astype(np.int64))

    def off(b, ci):  # band-b merged index offset of component ci
        return int(offs[b - 1][ci])

    levels = []
    # band 0: global ids, parent composed per component
    parent0 = np.zeros(n, np.int32)
    for ci, (e, vs) in enumerate(zip(exports, index_maps)):
        l0 = e.levels[0]
        # a single-level component repeats identically in band 1 → identity
        p = (l0.parent if l0.parent is not None
             else np.arange(l0.n, dtype=np.int32))
        parent0[vs] = p + off(1, ci)
    levels.append(LevelExport(n=n, edges=np.asarray(edges, np.int64),
                              parent=parent0,
                              rep=np.arange(n, dtype=np.int64)))
    for b in range(1, n_bands):
        es, reps, parents = [], [], []
        nb = 0
        for ci, (e, vs) in enumerate(zip(exports, index_maps)):
            lvl = e.levels[min(b, len(e.levels) - 1)]
            es.append(lvl.edges + off(b, ci))
            reps.append(vs[lvl.rep])             # component-local → global id
            if b < n_bands - 1:
                if b + 1 < len(e.levels):
                    parents.append(lvl.parent + off(b + 1, ci))
                else:  # saturated: same level repeats in the next band
                    parents.append(np.arange(lvl.n, dtype=np.int32)
                                   + off(b + 1, ci))
            nb += lvl.n
        levels.append(LevelExport(
            n=nb,
            edges=(np.concatenate(es) if es else np.zeros((0, 2), np.int64)),
            parent=(np.concatenate(parents).astype(np.int32)
                    if b < n_bands - 1 else None),
            rep=np.concatenate(reps).astype(np.int64)))
    return HierarchyExport(levels=levels, pos=np.asarray(pos, np.float32))


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
                     cfg: LayoutConfig | None = None, *,
                     export: bool = False, weights=None, device=None):
    """Full pipeline on a possibly-disconnected graph → (pos float32[n, 2]
    on the host, LayoutStats), and with ``export=True`` the merged
    ``HierarchyExport`` (the serving layer's input, serve/tiles.py) as a
    third item. ``weights`` (float[m], optional) are the per-edge weights
    (see ``layout_component``). ``device=None`` means the card; with no
    card present the call raises."""
    cfg = cfg or LayoutConfig()
    _check_supported(cfg)
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    weights = _check_weights(edges, weights)
    comps = _components(edges, n, weights)
    if len(comps) == 1:
        return layout_component(edges, n, cfg, export=export,
                                weights=weights, device=dev)
    outs = [layout_component(ce, vs.size, cfg, export=export, weights=cw,
                             device=dev) for vs, ce, cw in comps]
    maps = [vs for vs, _, _ in comps]
    pos, stats = _assemble(n, maps, [o[:2] for o in outs])
    if not export:
        return pos, stats
    return pos, stats, _merge_exports([o[2] for o in outs], maps, edges, n,
                                      pos)


def _check_weights(edges: np.ndarray, weights):
    """``weights`` as float32[m], or None; a count other than the edges'
    is a ValueError."""
    if weights is None:
        return None
    weights = np.asarray(weights, np.float32).reshape(-1)
    if len(weights) != len(edges):
        raise ValueError(f"{len(weights)} weights for {len(edges)} edges")
    return weights


def _components(edges: np.ndarray, n: int, weights) -> list:
    """(vertex ids, component-local edges, their weights or None) of each
    connected component, in label order."""
    labels = connected_components(edges, n)
    out = []
    for c in np.unique(labels):
        vs = np.nonzero(labels == c)[0]
        remap = np.full(n, -1, np.int64)
        remap[vs] = np.arange(vs.size)
        emask = labels[edges[:, 0]] == c
        ce = np.stack([remap[edges[emask, 0]], remap[edges[emask, 1]]], 1)
        out.append((vs, ce, weights[emask] if weights is not None else None))
    return out


def _assemble(n: int, index_maps: list, results: list):
    """The components' (pos, stats) shelf-packed into one drawing of n
    vertices → (pos, LayoutStats): levels the deepest, phase seconds
    summed."""
    stats = LayoutStats()
    for _, s in results:
        stats.levels = max(stats.levels, s.levels)
        for k, v in s.phase_seconds.items():
            stats.phase_seconds[k] += v
    packed = _pack_components([np.asarray(p) for p, _ in results])
    pos = np.zeros((n, 2), np.float32)
    for vs, P in zip(index_maps, packed):
        pos[vs] = P
    return pos, stats


# -- the batched multi-graph driver -------------------------------------------

class _ComponentTask:
    """The pipeline of one connected component as a state machine, for
    both drivers.

    Construction runs everything up to refinement (pruning → hierarchy →
    schedules, on ``device``); ``next_level`` then hands out one level at
    a time (coarsest first: its random init; below it, the placer's
    output) and ``feed`` takes its refined positions back, reinserting the
    pruned leaves after the finest. ``layout_component`` refines each
    level on its own; the batched driver re-pads it to its lane bucket
    (``next_request``) and refines it in a group, which changes no real
    vertex, so every fed-back position is the sequential driver's.
    """

    def __init__(self, edges: np.ndarray, n: int, cfg: LayoutConfig, *,
                 device, lane: object = None, weights=None):
        self.cfg, self.n, self.device = cfg, n, device
        self.lane = lane             # label: "<job uid>.<component>"
        self.stats = LayoutStats()
        self.final: np.ndarray | None = None
        self.pr = None
        self.graphs, self.infos = None, None    # no hierarchy: one level
        if n == 1:
            self.final = np.zeros((1, 2), np.float32)
            return
        if cfg.prune and cfg.driver != "flat":
            self.pr = prune_degree_one(edges, n, weights=weights)
        if self.pr is not None:
            self.work_edges, work_n = self.pr.edges, self.pr.n
            mass, work_ewt = self.pr.mass, self.pr.ewt
        else:
            self.work_edges = np.asarray(edges, np.int64).reshape(-1, 2)
            work_n, mass, work_ewt = n, None, weights
        if work_n == 0 or len(self.work_edges) == 0:
            # star graphs collapse entirely under pruning: leaves only
            self.final = (reinsert(self.pr,
                                   np.zeros((max(work_n, 1), 2), np.float32),
                                   self.work_edges)
                          if self.pr is not None
                          else np.zeros((n, 2), np.float32))
            return
        with _phase(self.stats, device, "coarsen"):
            self.g0 = build_graph(self.work_edges, work_n, mass=mass,
                                  ewt=work_ewt, bucket=cfg.bucketing,
                                  device=device)
            if cfg.driver == "flat":
                self.graphs, self.infos = [self.g0], []
            else:
                with obs_trace.span("coarsen", cat="host", lane=lane,
                                    n=self.g0.n, m=self.g0.m):
                    self.graphs, self.infos = build_hierarchy(
                        self.g0, cfg, device=device)
        L = len(self.graphs)
        self.scheds = [_schedule(cfg, i, L, g)
                       for i, g in enumerate(self.graphs)]
        self.stats.levels = L
        self.stats.level_sizes = tuple((g.n, g.m) for g in self.graphs)
        self.stats.level_modes = tuple(s.mode for s in self.scheds)
        self._level = L - 1          # next level to refine (coarsest first)
        self._pos = None             # refined positions of the level above

    @property
    def done(self) -> bool:
        return self.final is not None

    def next_level(self) -> tuple:
        """(level i, its graph, pos0, schedule, k-hop seed): the coarsest
        level's random init (flat: the only level), below it the placer's
        output from the level above's refined positions."""
        cfg, i, L = self.cfg, self._level, len(self.graphs)
        gi = self.graphs[i]
        if i == L - 1:
            with _phase(self.stats, self.device, "refine"):
                pos0 = gila.random_init(
                    gi, cfg.ideal_len * max(gi.n, 4) ** 0.5, cfg.seed)
            seed = cfg.seed if cfg.driver == "flat" else cfg.seed + L
        else:
            with obs_trace.span("place", cat="host", level=i,
                                lane=self.lane), \
                    _phase(self.stats, self.device, "place"):
                pos0 = solar_placer(gi, self.infos[i], self._pos,
                                    seed=cfg.seed + i,
                                    scatter_scale=0.5 * cfg.ideal_len)
            seed = cfg.seed + i
        return i, gi, pos0, self.scheds[i], seed

    def next_request(self) -> bucketing.RefineRequest:
        """The next level re-padded to its lane bucket, with its incidence
        table (``bucketing.make_request``)."""
        i, gi, pos0, sched, seed = self.next_level()
        return bucketing.make_request(gi, pos0, sched, seed, level=i,
                                      lane=self.lane)

    def feed(self, pos: torch.Tensor) -> None:
        """Take the refined positions of the current level; after the finest
        one, reinsert the pruned leaves."""
        self._pos = pos
        self._level -= 1
        if self._level >= 0:
            return
        p = pos.cpu().numpy().astype(np.float32)[: self.g0.n]
        self.final = (reinsert(self.pr, p, self.work_edges)
                      if self.pr is not None else p)

    def export(self, edges: np.ndarray) -> HierarchyExport:
        """The finished component's ``HierarchyExport`` (``edges`` are the
        component's input edges)."""
        if not self.done:
            raise RuntimeError("export of an unfinished component")
        if self.graphs is None:
            return _single_level_export(edges, self.n, self.final)
        return _build_export(edges, self.n, self.pr, self.graphs, self.infos,
                             self.final)


class GraphJob:
    """One submitted graph in a ``WaveScheduler``'s lane set: one
    ``_ComponentTask`` lane per connected component, reassembled by
    ``result()`` (shelf packing, as ``multigila_layout`` does) once every
    lane has refined its finest level. A ``cancelled`` job's lanes are
    skipped by the scheduler, without touching any sibling lane's floats."""

    def __init__(self, edges, n: int, cfg: LayoutConfig, *, device,
                 uid: int = -1, weights=None):
        self.cfg, self.n = cfg, int(n)
        self.uid = int(uid)          # the scheduler's admission rank
        self.cancelled = False
        edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
        weights = _check_weights(edges, weights)
        comps = _components(edges, self.n, weights)
        self.index_maps = [vs for vs, _, _ in comps]
        self.tasks = [_ComponentTask(ce, vs.size, cfg, device=device,
                                     lane=f"{self.uid}.{k}", weights=cw)
                      for k, (vs, ce, cw) in enumerate(comps)]

    @property
    def lanes(self) -> int:
        """Live (unfinished) lanes this job still occupies."""
        return 0 if self.cancelled else sum(not t.done for t in self.tasks)

    @property
    def done(self) -> bool:
        return self.cancelled or all(t.done for t in self.tasks)

    def result(self):
        """(pos float32[n, 2], LayoutStats), as ``multigila_layout``
        returns them."""
        if not self.done or self.cancelled:
            raise RuntimeError(f"job {self.uid}: no result "
                               f"({'cancelled' if self.cancelled else 'running'})")
        if len(self.tasks) == 1:
            return self.tasks[0].final, self.tasks[0].stats
        return _assemble(self.n, self.index_maps,
                         [(t.final, t.stats) for t in self.tasks])


# wave-composition metrics: counted at dispatch, so that the one-shot
# batched driver and the continuous engine both feed them
WAVES_TOTAL = obs_metrics.REGISTRY.counter(
    "gila_waves_total", "Dispatched waves (>= 1 lane)")
LANE_DISPATCHES_TOTAL = obs_metrics.REGISTRY.counter(
    "gila_lane_dispatches_total", "Per-level lane refinements dispatched")
PREEMPTED_LANES_TOTAL = obs_metrics.REGISTRY.counter(
    "gila_preempted_lanes_total",
    "Lanes held past a wave because the wave cap was full")
STRAGGLER_WAVES_TOTAL = obs_metrics.REGISTRY.counter(
    "gila_straggler_waves_total",
    "Waves slower than the StepTimer EWMA threshold")
WAVE_GROUPS_HIST = obs_metrics.REGISTRY.histogram(
    "gila_wave_groups", "Shape-bucket groups per dispatched wave",
    buckets=(1, 2, 3, 4, 6, 8, 12, 16, 24, 32))
GROUP_LANES_HIST = obs_metrics.REGISTRY.histogram(
    "gila_group_lanes", "Member lanes per dispatched shape-bucket group",
    buckets=(1, 2, 4, 8, 16, 32, 64, 128))


class WaveScheduler:
    """Wave scheduler over a mutable lane set: ``admit`` / ``remove`` /
    ``step`` / ``drain``.

    Each ``step()`` dispatches ONE wave: every selected lane's next level,
    its refinements grouped by ``bucketing.group_key`` and run as batched
    programs through ``dispatch`` (default ``bucketing.refine_level_many``).
    A job admitted between steps joins the next wave's grouping; lane counts
    re-bucket to pow2 (floor 8, capped by ``lanes_cap``), so a warm cache
    captures nothing for it. Lanes are independent, so wave membership
    changes no lane's floats: every job's result is that of a dedicated
    ``multigila_layout`` call with the same seed, whenever it joined and
    whichever siblings rode along.

    ``step(order=...)`` sorts jobs by that key before picking lanes, and
    ``max_lanes`` truncates the wave to the first lanes: the others are
    preempted (they ride when capacity frees). Pending requests are staged
    once a level and kept across preempted waves, so placement never reruns.
    ``clock`` times the waves for the straggler count (``StepTimer``) and
    the spans: ``tracer`` (default: the process tracer) gets a ``wave``
    span a wave, a ``refine.group`` span a group and a ``refine`` span a
    lane (the group's bounds, labeled with the lane's level and job), and
    a ``wave.straggler`` instant. ``waves``, ``lane_dispatches`` and
    ``straggler_waves`` count what this scheduler ran; the families
    ``gila_waves_total`` and the rest count it process-wide.
    """

    def __init__(self, cfg: LayoutConfig | None = None, *,
                 lanes_cap: int | None = None, dispatch=None,
                 tracer: obs_trace.Tracer | None = None,
                 clock: Clock | None = None, device=None):
        cfg = cfg or LayoutConfig()
        if cfg.driver != "multigila":
            raise ValueError("WaveScheduler supports driver='multigila' "
                             f"only, got {cfg.driver!r}")
        if not cfg.bucketing:
            raise ValueError("WaveScheduler requires cfg.bucketing=True")
        _check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lanes_cap = lanes_cap
        # the engine hands over ITS clock and tracer, so that wave spans,
        # straggler timing and its scheduling log share one time frame (a
        # VirtualClock does not move inside step(): a simulated wave takes
        # 0 s and never counts as a straggler)
        self.tracer = tracer if tracer is not None else obs_trace.get_tracer()
        self.clock = clock or SystemClock()
        self._wave_timer = StepTimer()
        self._dispatch = dispatch or self._refine_group
        self._group_phases = None
        self._jobs: list[GraphJob] = []
        self._staged: dict = {}       # _ComponentTask → RefineRequest
        self._next_uid = 0
        self.waves = 0
        self.lane_dispatches = 0
        self.straggler_waves = 0

    def _refine_group(self, reqs):
        """The default dispatch: one group through the step cache, its
        seconds booked for the lanes' shares."""
        return bucketing.refine_level_many(
            reqs, ideal_len=self.cfg.ideal_len, rep_const=self.cfg.rep_const,
            lanes_cap=self.lanes_cap, phases=self._group_phases)

    def admit(self, edges, n: int, *, seed: int | None = None,
              engine: str | None = None, weights=None) -> GraphJob:
        """Add one graph to the lane set (at any wave boundary). ``seed`` and
        ``engine`` override the scheduler's config for this job only: a wave
        may mix engines, grouped apart by ``group_key``."""
        cfg = self.cfg
        if seed is not None:
            cfg = dataclasses.replace(cfg, seed=int(seed))
        if engine is not None:
            cfg = dataclasses.replace(cfg, engine=engine)
            _check_supported(cfg)
        job = GraphJob(edges, n, cfg, device=self.device,
                       uid=self._next_uid, weights=weights)
        self._next_uid += 1
        self._jobs.append(job)
        return job

    def remove(self, job: GraphJob) -> None:
        """Cancel a job: free its lanes and drop its staged requests; the
        sibling lanes are untouched."""
        job.cancelled = True
        for t in job.tasks:
            self._staged.pop(t, None)
        if job in self._jobs:
            self._jobs.remove(job)

    @property
    def active(self) -> bool:
        return any(not j.done for j in self._jobs)

    def lanes_live(self) -> int:
        return sum(j.lanes for j in self._jobs)

    def step(self, *, order=None, max_lanes: int | None = None) -> dict:
        """Dispatch one wave → ``{"lanes", "groups", "preempted"}``, with
        ``groups`` the (group_key, member count) pairs in dispatch order and
        ``preempted`` the lanes held past this wave by ``max_lanes``.
        ``order``: a job sort key (ascending, stable: admission order breaks
        ties)."""
        self._jobs = [j for j in self._jobs if not j.done]
        jobs = (sorted(self._jobs, key=order) if order is not None
                else list(self._jobs))
        pend = []
        for j in jobs:
            for t in j.tasks:
                if t.done:
                    continue
                r = self._staged.get(t)
                if r is None:
                    r = self._staged[t] = t.next_request()
                pend.append((t, r))
        preempted = 0
        if max_lanes is not None:
            preempted = max(0, len(pend) - max_lanes)
            pend = pend[:max_lanes]
        groups: dict = {}
        for t, r in pend:
            groups.setdefault(bucketing.group_key(r), []).append((t, r))
        tw0 = self.clock.now()
        ginfo = []
        for key, members in groups.items():
            self._group_phases = {"refine": 0.0, "compile": 0.0}
            tg0 = self.clock.now()
            outs = self._dispatch([r for _, r in members])
            tg1 = self.clock.now()
            for (t, r), pos in zip(members, outs):
                del self._staged[t]
                for k, v in self._group_phases.items():
                    t.stats.phase_seconds[k] += v / len(members)
                t.feed(pos)
                # the lane's share of the group dispatch: the group's bounds,
                # labeled with its level and lane
                self.tracer.complete("refine", tg0, tg1, cat="wave",
                                     level=r.level, lane=r.lane)
            self.tracer.complete("refine.group", tg0, tg1, cat="wave",
                                 bucket=key, lanes=len(members))
            GROUP_LANES_HIST.observe(len(members))
            ginfo.append((key, len(members)))
        if pend:
            tw1 = self.clock.now()
            self.waves += 1
            self.lane_dispatches += len(pend)
            WAVES_TOTAL.inc()
            LANE_DISPATCHES_TOTAL.inc(len(pend))
            WAVE_GROUPS_HIST.observe(len(ginfo))
            if preempted:
                PREEMPTED_LANES_TOTAL.inc(preempted)
            self.tracer.complete("wave", tw0, tw1, cat="wave",
                                 lanes=len(pend), groups=ginfo,
                                 preempted=preempted)
            if self._wave_timer.record(tw1 - tw0):
                self.straggler_waves += 1
                STRAGGLER_WAVES_TOTAL.inc()
                self.tracer.instant("wave.straggler", ts=tw1, cat="wave",
                                    dur=tw1 - tw0,
                                    ewma=self._wave_timer.ewma)
        return {"lanes": len(pend), "groups": ginfo, "preempted": preempted}

    def drain(self) -> None:
        """Step until every admitted job has finished."""
        while self.step()["lanes"]:
            pass


def multigila_layout_many(graphs: list, cfg: LayoutConfig | None = None, *,
                          seeds: list | None = None,
                          engines: list | None = None,
                          weights: list | None = None, device=None) -> list:
    """Batched Multi-GiLA: lay out B graphs through grouped per-level
    refinements, one batched program per shape bucket a wave.

    ``graphs`` is a list of ``(edges, n)``; ``seeds`` / ``engines`` /
    ``weights`` override ``cfg.seed`` / ``cfg.engine`` / the per-edge
    weights per graph. Returns ``[(pos float32[n, 2], LayoutStats)]`` in
    input order, each equal to ``multigila_layout`` of that graph alone
    (bit for bit on the CPU; on the card the sequential driver sums its
    edges with atomics). The one-shot wrapper over ``WaveScheduler``:
    admit everything, drain, collect. ``device=None`` means the card."""
    cfg = cfg or LayoutConfig()
    for name, lst in (("seeds", seeds), ("engines", engines),
                      ("weights", weights)):
        if lst is not None and len(lst) != len(graphs):
            raise ValueError(f"{name} must match graphs in length")
    sched = WaveScheduler(cfg, device=device)
    jobs = [sched.admit(edges, n,
                        seed=None if seeds is None else int(seeds[k]),
                        engine=None if engines is None else engines[k],
                        weights=None if weights is None else weights[k])
            for k, (edges, n) in enumerate(graphs)]
    sched.drain()
    return [job.result() for job in jobs]
