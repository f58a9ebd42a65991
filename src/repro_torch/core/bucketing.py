"""Shape buckets and the process-wide cache of refine step programs.

The JAX package's ``core/bucketing.py`` on torch. Every level of the
bucketed multilevel driver is padded to pow2 shape buckets
(``graphs.graph.bucket_pad``), so all levels of all hierarchies share
O(log n) shapes, and each level's refinement runs through one cached step
program per key

    ("refine", engine, n_pad, m_pad, K, mode, grid_dim, cell_cap, device)

— the JAX key with the device in the kernel backend's place. The program
(``engine.RefineProgram``) holds the step of ONE iteration over static
buffers; on the card it is a captured CUDA graph, replayed once per
iteration. The iteration count, the schedule rows (temperature, C·L², md²)
and the params (C, L, min_dist) are device data, not part of the key, so one
entry serves every level, graph, seed and constant whose arrays land in its
bucket, and a fresh graph whose levels land in warm buckets captures
nothing new. On the CPU the same program runs its step eagerly on the same
buffers, so keys, hits and misses behave alike on both devices.

``refine_level`` books a cold entry's warm-up iteration plus its capture
under the ``compile`` phase and everything else (the k-hop build, staging,
replays) under ``refine``, in the caller's ``phases`` dict and in the
registry's ``gila_phase_seconds_total`` (``add_phase``).
``LayoutConfig(bucketing=False)`` bypasses this module: exact-shape
padding and the engine's eager ``refine`` loop.

The batched (multi-graph) driver groups the pending per-level refinements
of many graphs by ``group_key`` and runs each group as ONE batched program
(``engine.RefineManyProgram``) in the same cache, keyed

    ("refine_many", lanes, engine, n_pad, m_pad, cap, inc_k, mode,
     grid_dim, cell_cap, device)

Iteration budgets, temperatures and constants stay per-lane device data;
lanes whose budget is spent (and the dead lanes of a pow2 lane bucket)
carry their positions through the group's remaining iterations unchanged,
which keeps every lane's result that of the same level refined alone.

Observability, as in the JAX package: the cache's hits, misses and live
entries, the dispatches by engine and path, and the padding occupancy of
each batched dispatch are metric families of ``obs.metrics.REGISTRY``;
each dispatch is a ``refine.dispatch`` / ``refine_many.dispatch`` span of
the process tracer, which, when the tracer is on, ends with a device
synchronize so that the span holds the dispatch's device time (off, it
adds none).
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core.engine import get_engine
from repro_torch.graphs import packing
from repro_torch.graphs.graph import PaddedGraph, bucket_pad
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils.device import synchronize


# -- per-phase wall-clock accounting ------------------------------------------

# the drivers' phase seconds (``LayoutStats.phase_seconds``) also feed one
# labeled counter series a phase: the registry is lock-protected, and the
# engine worker thread and a caller thread add to it at once
PHASE_SECONDS = obs_metrics.REGISTRY.counter(
    "gila_phase_seconds_total",
    "Wall-clock seconds per pipeline phase (coarsen/place/refine/compile)",
    "seconds")


def add_phase(phases: dict | None, name: str, seconds: float) -> None:
    """Book ``seconds`` under phase ``name``: in ``phases`` (a
    ``LayoutStats.phase_seconds``-like dict, if given) and in
    ``gila_phase_seconds_total``."""
    seconds = max(float(seconds), 0.0)
    if phases is not None:
        phases[name] += seconds
    PHASE_SECONDS.inc(seconds, phase=name)


# -- the step cache ------------------------------------------------------------

CACHE_HITS = obs_metrics.REGISTRY.counter(
    "gila_compile_cache_hits_total",
    "Warm lookups of the process-wide compiled-step cache")
CACHE_MISSES = obs_metrics.REGISTRY.counter(
    "gila_compile_cache_misses_total",
    "Cold lookups (each one builds + compiles a new step program)")


class CompileCache:
    """Process-wide cache of step programs keyed on shape buckets.

    ``get(key, builder)`` returns ``(program, fresh)``; ``fresh=True`` means
    the builder ran (the program's first run warms up and captures).
    Lock-protected: callers in several threads share one instance."""

    def __init__(self):
        self.entries: dict = {}
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def get(self, key, builder):
        with self._lock:
            prog = self.entries.get(key)
            if prog is not None:
                self.hits += 1
                CACHE_HITS.inc()
                return prog, False
            self.misses += 1
            CACHE_MISSES.inc()
            prog = builder()
            self.entries[key] = prog
            return prog, True

    def clear(self) -> None:
        """Drop every entry (and with it its buffers and CUDA graph)."""
        with self._lock:
            self.entries.clear()
            self.hits = 0
            self.misses = 0


STEP_CACHE = CompileCache()


def cache_stats() -> dict:
    """entries/hits/misses of the step cache, single-graph and batched
    entries alike. The JAX package also reports ``jit_entries``, the
    trace-cache sizes of its jitted functions; PyTorch runs eagerly outside
    this cache, so the port has no counterpart."""
    return dict(entries=len(STEP_CACHE.entries), hits=STEP_CACHE.hits,
                misses=STEP_CACHE.misses)


# a callback gauge, sampled at scrape/snapshot time: a long-running
# service's /metrics reports the live cache state
obs_metrics.REGISTRY.gauge(
    "gila_compile_cache_entries",
    "Live compiled-step entries in the process-wide cache",
    fn=lambda: len(STEP_CACHE.entries))

# which refinement engine served how many cached-step dispatches, split by
# the single-graph and the batched path
REFINE_DISPATCHES = obs_metrics.REGISTRY.counter(
    "gila_refine_dispatches_total",
    "Cached refine-step dispatches, labeled by engine and dispatch path")


def _dispatch(span: str, prog, args, device, *, key, fresh, phases, t0,
              **span_args) -> torch.Tensor:
    """Run a cached program inside its dispatch span and book its seconds
    (``refine_level``, ``refine_level_many``). The device is synchronized
    only where the phases are timed or the tracer is on."""
    with obs_trace.span(span, cat="device", key=key, fresh=fresh,
                        **span_args):
        out = prog.run(*args)
        if phases is not None or obs_trace.TRACER.enabled:
            synchronize(device)
    if phases is not None:
        add_phase(phases, "compile", prog.compile_seconds)
        add_phase(phases, "refine",
                  time.perf_counter() - t0 - prog.compile_seconds)
    return out


def cached_refine(g: PaddedGraph, pos0, sched, nbr_idx, nbr_mask, *,
                  ideal_len: float, rep_const: float, min_dist: float = 1e-3):
    """(cache_key, program, fresh, args) for one level's bucketed refine:
    the single place where the key is derived and the program's arguments
    staged. ``sched.engine`` picks the step AND is part of the key, so gila
    and stress entries of one bucket never collide."""
    eng = get_engine(sched.engine)
    key = ("refine", sched.engine, g.n_pad, g.m_pad, int(nbr_idx.shape[1]),
           sched.mode, sched.grid_dim, sched.cell_cap, str(g.device))
    prog, fresh = STEP_CACHE.get(
        key, lambda: eng.build_refine(sched.mode, sched.grid_dim,
                                      sched.cell_cap))
    rows = eng.schedule_rows(sched, ideal_len=ideal_len, rep_const=rep_const,
                             min_dist=min_dist)
    params = np.asarray([rep_const, ideal_len, min_dist], np.float32)
    args = (g, pos0.to(device=g.device, dtype=torch.float32), nbr_idx,
            nbr_mask, rows, params)
    return key, prog, fresh, args


def refine_level(g: PaddedGraph, pos0, sched, *, ideal_len: float,
                 rep_const: float, min_dist: float = 1e-3, seed: int = 0,
                 phases: dict | None = None) -> torch.Tensor:
    """Refine one level for ``sched.iters`` iterations from ``pos0`` through
    the cached step program of its bucket. With ``phases`` (a
    ``LayoutStats.phase_seconds``), the warm-up and capture of a cold entry
    are added to ``phases["compile"]`` and the rest of the call, ended by a
    device synchronize, to ``phases["refine"]``."""
    t0 = time.perf_counter()
    eng = get_engine(sched.engine)
    nbr_idx, nbr_mask = eng.init_state(g, sched, seed)
    key, prog, fresh, args = cached_refine(
        g, pos0, sched, nbr_idx, nbr_mask, ideal_len=ideal_len,
        rep_const=rep_const, min_dist=min_dist)
    pos = _dispatch("refine.dispatch", prog, args, g.device, key=key,
                    fresh=fresh, phases=phases, t0=t0, mode=sched.mode,
                    engine=sched.engine)
    REFINE_DISPATCHES.inc(engine=sched.engine, path="single")
    return pos


# -- the batched (multi-graph) refinement step ---------------------------------

# Lane shape-bucket floors of the batched driver. The vertex floor sits below
# the single-graph driver's 256: a 45-vertex coarse level costs 64² pairs a
# lane instead of 256² (padding changes no real vertex's result). The edge
# floor is coarser than a pow2 of 2m so that small wobbles in coarse-level
# edge counts from seed to seed do not mint fresh cache keys.
BATCH_MIN_N = 64
BATCH_MIN_E = 512
# the incidence tables' fixed column count: lanes whose max degree fits sum
# their edges by gathered adds; hub-heavy lanes (inc_k 0) by a flat scatter
INC_K_MAX = 32


@dataclasses.dataclass
class RefineRequest:
    """One graph level's refinement queued for a batched group dispatch.

    ``g``/``pos0`` are re-padded to the lane bucket (``lane_shape``);
    ``sched`` carries the level's iteration budget and mode; ``seed`` feeds
    the k-hop build; ``inc``/``inc_k`` the incidence table (inc_k 0: the
    group sums its edges with a flat scatter). Build with ``make_request``.
    ``level``/``lane`` are labels only and stay out of ``group_key``, so
    equal shapes at different levels share one program."""
    g: PaddedGraph
    pos0: torch.Tensor
    sched: object            # core.schedule.LevelSchedule
    seed: int
    inc: torch.Tensor
    inc_k: int
    level: int = 0
    lane: object = None


def lane_shape(n: int, m: int) -> tuple[int, int]:
    """(n_pad, m_pad) lane bucket of a level with n vertices, m edges."""
    return bucket_pad(n, BATCH_MIN_N), bucket_pad(2 * m, BATCH_MIN_E)


def make_request(g: PaddedGraph, pos0, sched, seed: int, *, level: int = 0,
                 lane: object = None) -> RefineRequest:
    """Re-pad one level to its lane bucket and attach its incidence table."""
    n_pad, m_pad = lane_shape(g.n, g.m)
    g2 = packing.repad_graph(g, n_pad, m_pad)
    inc, k = packing.incidence_table(g2, INC_K_MAX)
    if inc is None:               # hub-heavy lane: flat-scatter edge sums
        inc, k = torch.zeros((n_pad, 0), dtype=torch.int32,
                             device=g.device), 0
    return RefineRequest(g=g2, pos0=packing.repad_rows(pos0, n_pad),
                         sched=sched, seed=seed, inc=inc, inc_k=k,
                         level=int(level), lane=lane)


def group_key(req: RefineRequest) -> tuple:
    """Shape-bucket grouping key: requests with equal keys share one
    batched program (and one dispatch a wave)."""
    s = req.sched
    cap = s.cap if s.mode == "neighbor" else 1
    return (s.engine, req.g.n_pad, req.g.m_pad, cap, req.inc_k, s.mode,
            s.grid_dim, s.cell_cap)


# padding occupancy, the direct measure of fragmentation loss: the share of
# each dispatched [lanes, n_pad] / [lanes, m_pad] batch volume that holds
# TRUE vertices / edge slots rather than pow2 padding, labeled by the shape
# bucket
OCC_VERTICES = obs_metrics.REGISTRY.gauge(
    "gila_wave_padding_occupancy_vertices",
    "True vertices / (lanes * n_pad) of the last dispatch per bucket",
    "ratio")
OCC_EDGES = obs_metrics.REGISTRY.gauge(
    "gila_wave_padding_occupancy_edges",
    "True directed edge slots / (lanes * m_pad) of the last dispatch",
    "ratio")
OCC_LANES = obs_metrics.REGISTRY.gauge(
    "gila_wave_lane_occupancy",
    "Live lanes / pow2 lane bucket of the last dispatch per bucket",
    "ratio")


def _record_occupancy(reqs: list[RefineRequest], lanes: int) -> None:
    n_pad, m_pad = reqs[0].g.n_pad, reqs[0].g.m_pad
    bucket = f"n{n_pad}_e{m_pad}"
    OCC_VERTICES.set(sum(r.g.n for r in reqs) / (lanes * n_pad),
                     bucket=bucket)
    OCC_EDGES.set(sum(2 * r.g.m for r in reqs) / (lanes * m_pad),
                  bucket=bucket)
    OCC_LANES.set(len(reqs) / lanes, bucket=bucket)


def lane_schedule_rows(eng, reqs: list[RefineRequest], lanes: int, *,
                       ideal_len: float, rep_const: float,
                       min_dist: float = 1e-3) -> np.ndarray:
    """float32[lanes, max iters, 3]: each lane's schedule rows, the rows
    past its budget repeating its last one, and dead lanes lane 0's."""
    per = [eng.schedule_rows(r.sched, ideal_len=ideal_len,
                             rep_const=rep_const, min_dist=min_dist)
           for r in reqs]
    rows = np.empty((lanes, max(len(r) for r in per), 3), np.float32)
    for i, r in enumerate(per):
        rows[i, :len(r)] = r
        rows[i, len(r):] = r[-1]
    rows[len(per):] = rows[0]
    return rows


def cached_refine_many(reqs: list[RefineRequest], nbrs: list[tuple], *,
                       ideal_len: float, rep_const: float,
                       min_dist: float = 1e-3, lanes_min: int = 8):
    """(cache_key, program, fresh, args) for one batched group: the single
    place where the batched key is derived and its arguments staged.
    ``nbrs`` is each request's (nbr_idx, nbr_mask) (dummies outside
    neighbor mode)."""
    key0 = group_key(reqs[0])
    if any(group_key(r) != key0 for r in reqs):
        raise ValueError("cached_refine_many: requests of several groups")
    sched0 = reqs[0].sched
    eng = get_engine(sched0.engine)
    b = len(reqs)
    lanes = packing.lane_bucket(b, lanes_min)
    packed = packing.pack_graphs([r.g for r in reqs], lanes=lanes)
    _record_occupancy(reqs, lanes)
    pl = lambda ts: packing.pad_lanes(torch.stack(ts), b, lanes)
    pos0 = pl([r.pos0.to(dtype=torch.float32) for r in reqs])
    nbr_idx = pl([ni for ni, _ in nbrs])
    nbr_mask = pl([nm for _, nm in nbrs])
    inc = pl([r.inc for r in reqs])
    # dead lanes: an iteration budget of 0 — they ride through untouched
    iters = np.asarray([r.sched.iters for r in reqs] + [0] * (lanes - b))
    rows = lane_schedule_rows(eng, reqs, lanes, ideal_len=ideal_len,
                     rep_const=rep_const, min_dist=min_dist)
    params = np.asarray([rep_const, ideal_len, min_dist], np.float32)
    cache_key = ("refine_many", lanes) + key0 + (str(packed.g.device),)
    prog, fresh = STEP_CACHE.get(
        cache_key, lambda: eng.build_refine_many(
            sched0.mode, sched0.grid_dim, sched0.cell_cap, reqs[0].inc_k))
    args = (packed.g, inc, pos0, nbr_idx, nbr_mask, iters, rows, params)
    return cache_key, prog, fresh, args


def refine_level_many(reqs: list[RefineRequest], *, ideal_len: float,
                      rep_const: float, min_dist: float = 1e-3,
                      lanes_min: int = 8, lanes_cap: int | None = None,
                      phases: dict | None = None) -> list[torch.Tensor]:
    """Run one group of refinements (all of one ``group_key``) as a single
    batched program → each request's refined positions [n_pad, 2] (its lane
    bucket's n_pad), in request order.

    ``lanes_cap`` bounds the lane bucket of one dispatch: a larger group is
    split into chunks of ≤ lanes_cap (lanes are independent, so chunking
    changes no bit). With ``phases`` (a ``LayoutStats.phase_seconds``-like
    dict), a cold entry's warm-up and capture are added to
    ``phases["compile"]`` and the rest, ended by a device synchronize, to
    ``phases["refine"]``."""
    if not reqs:
        raise ValueError("refine_level_many: no requests")
    if lanes_cap is not None and len(reqs) > lanes_cap:
        out = []
        for i in range(0, len(reqs), lanes_cap):
            out.extend(refine_level_many(
                reqs[i:i + lanes_cap], ideal_len=ideal_len,
                rep_const=rep_const, min_dist=min_dist, lanes_min=lanes_min,
                lanes_cap=lanes_cap, phases=phases))
        return out
    t0 = time.perf_counter()
    r0 = reqs[0]
    eng = get_engine(r0.sched.engine)
    # per-lane engine state: the k-hop lists of neighbor mode, from the same
    # code and seed as the single-graph driver's (the same lists)
    if r0.sched.mode == "neighbor":
        nbrs = [eng.init_state(r.g, r.sched, r.seed) for r in reqs]
    else:
        nbrs = [eng.init_state(r0.g, r0.sched, r0.seed)] * len(reqs)
    key, prog, fresh, args = cached_refine_many(
        reqs, nbrs, ideal_len=ideal_len, rep_const=rep_const,
        min_dist=min_dist, lanes_min=lanes_min)
    out = _dispatch("refine_many.dispatch", prog, args, r0.g.device,
                    key=key, fresh=fresh, phases=phases, t0=t0,
                    lanes=len(reqs), engine=r0.sched.engine)
    REFINE_DISPATCHES.inc(engine=r0.sched.engine, path="many")
    return [out[i] for i in range(len(reqs))]
