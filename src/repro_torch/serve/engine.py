"""Continuous-batching layout engine: the JAX package's ``serve/engine.py``
on the port's ``WaveScheduler``.

``LayoutService`` (serve/layout_service.py) coalesces requests into fixed
deadline-window batches: a batch forms, runs to completion, and everything
that arrived meanwhile waits for the next one. This module uses the
mechanism LLM serving uses, *continuous batching*: a persistent engine owns
the ``core.multilevel.WaveScheduler`` and admits new requests into the lane
set *between* level waves, so a late request rides the very next wave
alongside requests already mid-hierarchy. Lane buckets are pow2 with a
floor (graphs/packing.py) and capped (``lanes_cap`` in
``bucketing.refine_level_many``), so a warm engine captures nothing for a
mid-flight join, and lanes are independent, so every result equals a
dedicated ``multigila_layout`` call's (bit for bit on the CPU; on the card
the dedicated driver sums its edges with atomics).

Three layers, separated so the scheduler is testable without wall clock:

  * ``EngineCore`` — a single-driver state machine: bounded admission
    queue (backpressure → ``EngineBusy``), per-request priorities and
    deadlines honored by the wave picker, cancellation that frees lanes,
    and a deterministic scheduling log. It reads time ONLY through its
    ``Clock``, so the same scripted trace replays to the same log — the
    JAX package's log, entry for entry, on the same trace.
  * the simulation rig — ``VirtualClock`` + ``SimEvent`` traces
    (``poisson_trace`` for seeded Poisson arrivals) + ``run_sim``, which
    drives an ``EngineCore`` through a trace charging a wave cost model to
    the virtual clock; ``null_dispatch`` stubs out device work entirely.
  * ``ContinuousLayoutService`` — the always-on threaded front door: a
    worker thread (``engine-worker``) ticks the core under the system
    clock, so all of the service's device work (on ``device``, default the
    card) runs on that thread; ``submit`` returns a Future-backed
    ``LayoutRequest`` handle.

Deadlines, cancellations, and admissions take effect at wave boundaries
(a wave in flight is never interrupted). Larger ``priority`` values are
more urgent; ties break by submission order.
"""
from __future__ import annotations

import dataclasses
import math
import threading
from concurrent.futures import Future

import numpy as np

from repro_torch.core.engine import get_engine
from repro_torch.core.multilevel import LayoutConfig, WaveScheduler
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
# the Clock seam lives in obs/clock.py (the tracer shares it); re-exported
# here, as the JAX package does, for callers that import it from here
from repro_torch.obs.clock import Clock, SystemClock, VirtualClock


class EngineBusy(RuntimeError):
    """Backpressure: the admission queue is full — resubmit later."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before its layout finished."""


def validate_graph(edges, n: int) -> tuple[np.ndarray, int]:
    """Validate one layout request at the service boundary and return a
    defensively COPIED edge array.

    The copy is load-bearing: ``np.asarray`` aliases same-dtype input, so
    without it a caller mutating its ``edges`` array after submit would
    corrupt the shared batch mid-flight. Validation happens here, not in the batch:
    requests coalesce into shared driver calls, and one malformed graph
    must not fail (or silently corrupt) every request in its wave.
    """
    e = np.array(edges, dtype=np.int64, copy=True).reshape(-1, 2)
    n = int(n)
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    if e.size and (e.min() < 0 or e.max() >= n):
        raise ValueError(
            f"edge endpoints must lie in [0, {n}), got [{e.min()}, {e.max()}]")
    return e, n


# -- engine metrics (DESIGN.md §12) -------------------------------------------

ENGINE_REQUESTS = obs_metrics.REGISTRY.counter(
    "gila_engine_requests_total",
    "Engine request transitions, labeled by event "
    "(submitted/rejected/admitted/completed/expired/cancelled)")
QUEUE_DEPTH = obs_metrics.REGISTRY.gauge(
    "gila_engine_queue_depth", "Admission-queue depth (last observed)")
QUEUE_DEPTH_HWM = obs_metrics.REGISTRY.gauge(
    "gila_engine_queue_depth_hwm",
    "Admission-queue high-water mark since engine start")
REQUEST_LATENCY = obs_metrics.REGISTRY.histogram(
    "gila_request_latency_seconds",
    "End-to-end submit-to-complete latency of finished requests",
    "seconds")


# -- requests ------------------------------------------------------------------

@dataclasses.dataclass
class LayoutRequest:
    """Handle for one submitted graph; ``future`` resolves to
    ``(pos[n, 2], LayoutStats)``. Status walk: queued → running → done,
    with expired / cancelled / rejected exits."""
    rid: int
    edges: np.ndarray
    n: int
    seed: int | None
    engine: str | None              # refinement engine override (None = cfg's)
    priority: int
    deadline: float | None          # absolute, in the engine clock's frame
    t_submit: float
    future: Future
    status: str = "queued"
    job: object = None              # core.multilevel.GraphJob once admitted
    t_done: float | None = None

    def result(self, timeout: float | None = None):
        return self.future.result(timeout)

    @property
    def latency(self) -> float | None:
        return None if self.t_done is None else self.t_done - self.t_submit


class EngineCore:
    """Continuous-batching state machine over a ``WaveScheduler``.

    Single-driver: exactly one thread (the owner) may call ``tick``;
    ``submit``/``cancel``/``stats`` are safe from any thread (they touch
    only lock-protected queue state, never the scheduler). Each ``tick``
    runs one engine cycle at the current clock reading:

      1. finalize cancellations requested while the last wave ran;
      2. expire queued and running requests whose deadline has passed
         (the lane is freed; siblings are untouched);
      3. admit the most urgent queued requests while lane capacity
         remains — this is the mid-flight join;
      4. dispatch ONE wave, lanes ordered by urgency and truncated to
         ``wave_lanes`` (lanes past the cap are preempted until capacity
         frees — that is how priorities/deadlines shape device time);
      5. harvest finished jobs and resolve their futures.

    Every transition appends to ``log`` — tuples of
    ``(t, kind, rid, details)`` — which is bit-stable across reruns of the
    same (config, trace) under a ``VirtualClock``.
    """

    def __init__(self, cfg: LayoutConfig | None = None, *,
                 clock: Clock | None = None, max_queue: int = 64,
                 max_lanes: int = 32, wave_lanes: int | None = None,
                 dispatch=None, tracer: "obs_trace.Tracer | None" = None,
                 device=None):
        if max_lanes < 1 or max_queue < 1:
            raise ValueError(f"max_lanes {max_lanes} and max_queue "
                             f"{max_queue} must be >= 1")
        self.clock = clock or SystemClock()
        # engine clock and tracer are handed to the scheduler so wave
        # spans, straggler timing, and the scheduling-log instants all
        # share ONE time frame (virtual under sim → replayable traces)
        self.tracer = tracer if tracer is not None else obs_trace.get_tracer()
        self.max_queue = int(max_queue)
        self.max_lanes = int(max_lanes)
        self.wave_lanes = int(wave_lanes or max_lanes)
        self.sched = WaveScheduler(cfg, lanes_cap=self.wave_lanes,
                                   dispatch=dispatch, tracer=self.tracer,
                                   clock=self.clock, device=device)
        self._lock = threading.Lock()
        self._queue: list[LayoutRequest] = []
        self._running: list[LayoutRequest] = []
        self._req_of_job: dict = {}
        self._next_rid = 0
        self._queue_hwm = 0
        self.log: list[tuple] = []
        self.counters = dict(submitted=0, rejected=0, admitted=0,
                             completed=0, expired=0, cancelled=0, waves=0)

    # -- client surface (any thread) ------------------------------------------
    def submit(self, edges, n: int, *, priority: int = 0,
               deadline_s: float | None = None,
               seed: int | None = None,
               engine: str | None = None) -> LayoutRequest:
        """Enqueue one graph; raises ``EngineBusy`` when the admission
        queue is full (bounded-queue backpressure). ``deadline_s`` is
        relative to now; expiry resolves the future with
        ``DeadlineExceeded``. ``engine`` overrides the refinement engine
        for this request (waves mix engines freely — grouping is by
        (engine, shape bucket), DESIGN.md §14)."""
        e, n = validate_graph(edges, n)
        if engine is not None:
            # boundary validation: an unknown id must bounce here (HTTP
            # 400), not poison the engine worker mid-wave
            get_engine(engine)
            engine = str(engine)
        t = self.clock.now()
        with self._lock:
            rid = self._next_rid
            self._next_rid += 1
            if len(self._queue) >= self.max_queue:
                self._count("rejected")
                self._log("reject", t, rid, queue=len(self._queue))
                raise EngineBusy(
                    f"admission queue full ({self.max_queue} pending)")
            req = LayoutRequest(
                rid=rid, edges=e, n=n,
                seed=None if seed is None else int(seed),
                engine=engine,
                priority=int(priority),
                deadline=None if deadline_s is None else t + float(deadline_s),
                t_submit=t, future=Future())
            self._queue.append(req)
            self._count("submitted")
            self._queue_hwm = max(self._queue_hwm, len(self._queue))
            self._log("submit", t, rid, priority=req.priority,
                      deadline=None if req.deadline is None
                      else round(req.deadline, 9))
            self._sample_queue_depth(t)
        return req

    def cancel(self, req: LayoutRequest) -> bool:
        """Cancel a request. Queued: removed immediately. Running: its
        lanes are freed at the next wave boundary, without perturbing any
        sibling lane's result. Returns False if already finished."""
        with self._lock:
            t = self.clock.now()
            if req.status == "queued":
                self._queue.remove(req)
                self._log("cancel", t, req.rid, where="queued")
                self._finish(req, "cancelled", t)
                return True
            if req.status == "running":
                req.status = "cancelling"
                self._log("cancel", t, req.rid, where="running")
                return True
            return False

    def stats(self) -> dict:
        """Engine counters + a metrics-registry snapshot, taken atomically
        under the engine lock (no transition can interleave between the
        counter reads and the snapshot)."""
        with self._lock:
            d = dict(self.counters)
            d.update(queued=len(self._queue), running=len(self._running),
                     lanes_live=self.sched.lanes_live(),
                     max_lanes=self.max_lanes, max_queue=self.max_queue,
                     queue_depth_hwm=self._queue_hwm,
                     straggler_waves=self.sched.straggler_waves,
                     metrics=obs_metrics.REGISTRY.snapshot())
        return d

    @property
    def busy(self) -> bool:
        return bool(self._queue or self._running)

    def pending_deadlines(self) -> list[float]:
        with self._lock:
            return [r.deadline for r in self._queue + self._running
                    if r.deadline is not None]

    # -- engine cycle (owner thread only) --------------------------------------
    def tick(self) -> dict:
        """One engine cycle; returns what happened (see class docstring)."""
        t = self.clock.now()
        out = dict(admitted=0, completed=0, expired=0, cancelled=0,
                   wave=None)
        admits: list[LayoutRequest] = []
        with self._lock:
            for req in [r for r in self._running if r.status == "cancelling"]:
                self.sched.remove(req.job)
                self._running.remove(req)
                self._req_of_job.pop(req.job, None)
                self._finish(req, "cancelled", t)
                out["cancelled"] += 1
            for req in [r for r in self._queue
                        if r.deadline is not None and r.deadline <= t]:
                self._queue.remove(req)
                self._log("expire", t, req.rid, where="queued")
                self._finish(req, "expired", t)
                out["expired"] += 1
            for req in [r for r in self._running
                        if r.deadline is not None and r.deadline <= t]:
                self.sched.remove(req.job)
                self._running.remove(req)
                self._req_of_job.pop(req.job, None)
                self._log("expire", t, req.rid, where="running")
                self._finish(req, "expired", t)
                out["expired"] += 1
            free = self.max_lanes - self.sched.lanes_live()
            while self._queue and free > 0:
                req = min(self._queue, key=self._urgency)
                self._queue.remove(req)
                admits.append(req)
                free -= 1       # ≥ 1 lane per graph; extra components may
                                # briefly overshoot the cap by design

        # job construction = host-side coarsening; deliberately outside the
        # lock so concurrent submits never block on it
        for req in admits:
            job = self.sched.admit(req.edges, req.n, seed=req.seed,
                                   engine=req.engine)
            with self._lock:
                req.job = job
                req.status = "running"
                self._running.append(req)
                self._req_of_job[job] = req
                self._count("admitted")
                self._log("admit", t, req.rid, lanes=len(job.tasks))
                self._sample_queue_depth(t)
            out["admitted"] += 1

        if self.sched.active:
            summary = self.sched.step(
                order=lambda j: self._urgency(self._req_of_job[j]),
                max_lanes=self.wave_lanes)
            if summary["lanes"]:
                with self._lock:
                    self.counters["waves"] += 1
                    self._log("wave", t, -1, lanes=summary["lanes"],
                              groups=tuple(summary["groups"]))
                out["wave"] = summary

        td = self.clock.now()
        with self._lock:
            for req in [r for r in self._running
                        if r.status == "running" and r.job.done]:
                self._running.remove(req)
                self._req_of_job.pop(req.job, None)
                result = req.job.result()
                self._log("complete", td, req.rid,
                          latency=round(td - req.t_submit, 9))
                self._finish(req, "done", td, result=result)
                out["completed"] += 1
        return out

    def run_until_idle(self, max_ticks: int = 1_000_000) -> None:
        for _ in range(max_ticks):
            if not self.busy:
                return
            self.tick()
        raise RuntimeError("engine failed to drain")

    # -- internals -------------------------------------------------------------
    @staticmethod
    def _urgency(req: LayoutRequest) -> tuple:
        """Wave-picker/admission sort key: priority first (larger = more
        urgent), then earliest deadline, then submission order."""
        return (-req.priority,
                math.inf if req.deadline is None else req.deadline, req.rid)

    def _finish(self, req: LayoutRequest, status: str, t: float,
                result=None) -> None:
        # caller holds self._lock
        req.status = status
        req.t_done = t
        if status == "done":
            self._count("completed")
            REQUEST_LATENCY.observe(t - req.t_submit)
            # request-lifetime span on the shared timeline (explicit
            # engine-clock bounds, so it is sim-replayable)
            self.tracer.complete("request", req.t_submit, t, cat="engine",
                                 rid=req.rid)
            if req.future.set_running_or_notify_cancel():
                req.future.set_result(result)
        elif status == "expired":
            self._count("expired")
            if req.future.set_running_or_notify_cancel():
                req.future.set_exception(DeadlineExceeded(
                    f"request {req.rid} missed its deadline"))
        elif status == "cancelled":
            self._count("cancelled")
            req.future.cancel()
        else:                                   # pragma: no cover
            raise ValueError(f"unknown request status {status!r}")

    def _count(self, event: str) -> None:
        self.counters[event] += 1
        ENGINE_REQUESTS.inc(event=event)

    def _sample_queue_depth(self, t: float) -> None:
        # caller holds self._lock
        QUEUE_DEPTH.set(len(self._queue))
        QUEUE_DEPTH_HWM.set(self._queue_hwm)
        self.tracer.counter("engine.queue_depth", len(self._queue), ts=t)

    def _log(self, kind: str, t: float, rid: int, **detail) -> None:
        self.log.append((round(float(t), 9), kind, int(rid),
                         tuple(sorted(detail.items()))))
        # mirror the scheduling log onto the trace timeline as instants
        self.tracer.instant("engine." + kind, ts=t, cat="engine", rid=rid,
                            **detail)


# -- the deterministic simulation rig ------------------------------------------

@dataclasses.dataclass
class SimEvent:
    """One scripted event of a simulation trace: a ``submit`` carries a
    graph (and per-request knobs); a ``cancel`` targets the ``ref``-th
    event of the trace (which must be a submit)."""
    t: float
    kind: str = "submit"            # "submit" | "cancel"
    edges: object = None
    n: int = 0
    seed: int | None = None
    priority: int = 0
    deadline_s: float | None = None
    ref: int = -1


def poisson_trace(rate_hz: float, count: int, make_graph, *, seed: int = 0,
                  priorities=(0,), deadline_s: float | None = None,
                  t0: float = 0.0) -> list[SimEvent]:
    """Seeded Poisson arrival script: exponential inter-arrival gaps at
    ``rate_hz``; ``make_graph(i, rng) -> (edges, n)`` supplies the graphs
    and ``priorities`` is sampled uniformly per request. Same seed ⇒ the
    identical trace, which is what makes the service benchmark's smoke
    mode wall-clock-stable."""
    rng = np.random.RandomState(seed)
    t = float(t0)
    out = []
    for i in range(count):
        t += float(rng.exponential(1.0 / rate_hz))
        edges, n = make_graph(i, rng)
        out.append(SimEvent(t=t, edges=edges, n=n, seed=i,
                            priority=int(priorities[
                                int(rng.randint(len(priorities)))]),
                            deadline_s=deadline_s))
    return out


def null_dispatch(reqs: list) -> list:
    """Simulation executor: every lane's positions pass through unchanged
    — no device work at all, scheduling behavior only."""
    return [r.pos0 for r in reqs]


# default wave cost model for simulations: every shape-bucket GROUP in a
# wave pays a fixed dispatch cost, and lanes within a group ride nearly
# free — the strongly-sublinear regime BENCH_many.json measures (16 lanes
# ≈ 1.6× one lane). Charging per group rather than per wave makes
# mid-flight fragmentation — lanes spread across many levels — cost what
# it costs for real. Sims need the SHAPE of this model to be realistic,
# not the absolute numbers.
WAVE_COST_BASE_S = 0.030
WAVE_COST_PER_LANE_S = 0.0006


def default_wave_cost(wave: dict) -> float:
    groups = wave.get("groups") or [(None, wave["lanes"])]
    return sum(WAVE_COST_BASE_S + WAVE_COST_PER_LANE_S * cnt
               for _, cnt in groups)


def run_sim(core: EngineCore, events: list[SimEvent], *, wave_cost=None,
            max_waves: int = 1_000_000) -> list:
    """Drive an ``EngineCore`` (on a ``VirtualClock``) through a scripted
    arrival trace: events are delivered at their virtual times, each
    dispatched wave advances the clock by ``wave_cost(wave)``, and idle
    gaps jump straight to the next arrival or deadline. Returns one
    ``LayoutRequest`` handle per trace event (None for cancels and for
    submits rejected by backpressure). Deterministic: the same (core
    config, trace, cost model) replays to a bit-identical ``core.log``."""
    clock = core.clock
    if not isinstance(clock, VirtualClock):
        raise TypeError("run_sim requires an EngineCore on a VirtualClock")
    cost = wave_cost or default_wave_cost
    order = sorted(range(len(events)), key=lambda k: (events[k].t, k))
    handles: list = [None] * len(events)
    i = waves = stall = 0
    while True:
        while i < len(order) and events[order[i]].t <= clock.now() + 1e-12:
            k = order[i]
            ev = events[k]
            i += 1
            if ev.kind == "submit":
                try:
                    handles[k] = core.submit(
                        ev.edges, ev.n, priority=ev.priority,
                        deadline_s=ev.deadline_s, seed=ev.seed)
                except EngineBusy:
                    handles[k] = None
            elif ev.kind == "cancel":
                if handles[ev.ref] is not None:
                    core.cancel(handles[ev.ref])
            else:
                raise ValueError(f"unknown SimEvent kind {ev.kind!r}")
        if not core.busy and i >= len(order):
            return handles
        out = core.tick()
        if out["wave"]:
            stall = 0
            waves += 1
            if waves > max_waves:
                raise RuntimeError("simulation exceeded max_waves")
            clock.advance(cost(out["wave"]))
        elif any(out[k] for k in ("admitted", "completed", "expired",
                                  "cancelled")):
            stall = 0
        else:
            nxt = [events[order[i]].t] if i < len(order) else []
            nxt += core.pending_deadlines()
            future_ts = [x for x in nxt if x > clock.now() + 1e-12]
            if future_ts:
                stall = 0
                clock.advance(min(future_ts) - clock.now())
            else:
                stall += 1
                if stall > 3:
                    raise RuntimeError("simulation stalled with no events, "
                                       "no deadlines, and no progress")
                clock.advance(1e-6)


# -- the always-on threaded front door -----------------------------------------

class ContinuousLayoutService:
    """Always-on continuous-batching layout service (system clock).

    A worker thread owns the ``EngineCore`` and ticks it while work is
    pending; ``submit`` is thread-safe, validates/copies at the boundary,
    and returns a Future-backed ``LayoutRequest``. Unlike
    ``LayoutService``'s fixed windows, a request submitted while other
    layouts are mid-hierarchy joins their very next wave.

        svc = ContinuousLayoutService(LayoutConfig(seed=0))
        req = svc.submit(edges, n, priority=1, deadline_s=30.0)
        pos, stats = req.result()
        svc.cancel(other_req)           # frees its lanes, siblings unharmed
        svc.close()                     # drains pending work first
    """

    def __init__(self, cfg: LayoutConfig | None = None, *,
                 max_queue: int = 256, max_lanes: int = 32,
                 wave_lanes: int | None = None, poll_s: float = 0.002,
                 device=None):
        self.core = EngineCore(cfg, max_queue=max_queue, max_lanes=max_lanes,
                               wave_lanes=wave_lanes, device=device)
        self._poll_s = poll_s
        self._wake = threading.Event()
        self._lifecycle = threading.Lock()
        self._closed = False
        # named so the tracer renders the engine's track stably (tids are
        # assigned from thread names, obs/trace.py)
        self._worker = threading.Thread(target=self._run, daemon=True,
                                        name="engine-worker")
        self._worker.start()

    def submit(self, edges, n: int, *, priority: int = 0,
               deadline_s: float | None = None,
               seed: int | None = None,
               engine: str | None = None) -> LayoutRequest:
        with self._lifecycle:
            if self._closed:
                raise RuntimeError("service is closed")
            req = self.core.submit(edges, n, priority=priority,
                                   deadline_s=deadline_s, seed=seed,
                                   engine=engine)
        self._wake.set()
        return req

    def cancel(self, req: LayoutRequest) -> bool:
        ok = self.core.cancel(req)
        self._wake.set()
        return ok

    def layout(self, edges, n: int, timeout: float | None = None, **kw):
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(edges, n, **kw).result(timeout)

    def stats(self) -> dict:
        return self.core.stats()

    def _run(self):
        while True:
            if self.core.busy:
                self.core.tick()
                continue
            if self._closed:
                return
            # idle: sleep until woken by submit/cancel/close (short poll so
            # an expiring queued deadline is still noticed promptly)
            self._wake.wait(self._poll_s)
            self._wake.clear()

    def close(self) -> None:
        """Stop accepting work, drain what is pending, stop the worker."""
        with self._lifecycle:
            if self._closed:
                return
            self._closed = True
        self._wake.set()
        self._worker.join(timeout=120)
