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
    host, LayoutStats): a ``_ComponentTask`` walked level by level, each
    level refined on its own (``_refine``).

    ``weights`` (float[m], optional) are per-edge weights: the attraction
    term's ideal length ℓ_e = w_e·L, and the stress engine's target
    distances. They thread prune → build_graph → hierarchy (the solar
    merger compounds them into coarse ``ewt``)."""
    _check_supported(cfg)
    dev = resolve_device(device)
    task = _ComponentTask(edges, n, cfg, device=dev, weights=weights)
    while not task.done:
        _, g, pos, sched, seed = task.next_level()
        task.feed(_refine(task.stats, dev, cfg, g, pos, sched, seed))
    return task.final, task.stats


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
    weights = _check_weights(edges, weights)
    comps = _components(edges, n, weights)
    if len(comps) == 1:
        return layout_component(edges, n, cfg, weights=weights, device=dev)
    return _assemble(n, [vs for vs, _, _ in comps],
                     [layout_component(ce, vs.size, cfg, weights=cw,
                                       device=dev) for vs, ce, cw in comps])


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
            self.graphs, self.infos = (
                ([self.g0], []) if cfg.driver == "flat"
                else build_hierarchy(self.g0, cfg, device=device))
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
            with _phase(self.stats, self.device, "place"):
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
    ``clock`` times the waves for the straggler count (``StepTimer``).
    ``waves``, ``lane_dispatches`` and ``straggler_waves`` count what ran.
    """

    def __init__(self, cfg: LayoutConfig | None = None, *,
                 lanes_cap: int | None = None, dispatch=None,
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
            outs = self._dispatch([r for _, r in members])
            for (t, _), pos in zip(members, outs):
                del self._staged[t]
                for k, v in self._group_phases.items():
                    t.stats.phase_seconds[k] += v / len(members)
                t.feed(pos)
            ginfo.append((key, len(members)))
        if pend:
            self.waves += 1
            self.lane_dispatches += len(pend)
            if self._wave_timer.record(self.clock.now() - tw0):
                self.straggler_waves += 1
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
