"""The port's observability layer (``repro_torch.obs``: the metrics registry,
the span tracer) and its instrumentation of the core and the engine, held to
the live JAX package on the CPU.

Everything compared here is exact: Prometheus text and JSON snapshots for
the same scripted increments, trace-event files of a scripted
``VirtualClock`` run (names, phases, timestamps, args; thread ids assigned
by thread name), the ``EngineCore`` scheduling log under ``null_dispatch``,
the registry's family names, help texts, units and buckets, and the
padding-occupancy gauges against hand-computed ratios.
"""
import json
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import repro.core  # noqa: F401 (registers the JAX package's families)
import repro.serve.engine  # noqa: F401
from repro.core import LayoutConfig as JaxConfig
from repro.graphs import generators as G
from repro.obs import metrics as jax_metrics
from repro.obs import trace as jax_trace
from repro.obs.clock import VirtualClock as JaxClock
from repro.serve import engine as jax_engine
from repro_torch.core import LayoutConfig, bucketing
from repro_torch.core.schedule import make_schedule
from repro_torch.graphs.graph import bucket_pad, build_graph
from repro_torch.kernels import _build
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.clock import VirtualClock
from repro_torch.serve import engine as port_engine


# -- the registry ----------------------------------------------------------------

def _script_registry(mod):
    """The same increments on a fresh registry of ``mod`` (either package's
    ``obs.metrics``)."""
    r = mod.Registry()
    c = r.counter("t_hits_total", "hits", "")
    c.inc()
    c.inc(2, kind="warm")
    c.inc(0.25, kind="cold")
    g = r.gauge("t_ratio", "a ratio", "ratio")
    g.set(0.5, bucket="n64")
    g.set(1 / 3, bucket="n128_e512")
    h = r.histogram("t_lat_seconds", "latency", "seconds", buckets=(0.1, 1.0))
    for v in (0.05, 0.5, 2.0, 0.1):
        h.observe(v)
    h.observe(0.7, path="many")
    r.gauge("t_live", "callback", fn=lambda: 7)
    r.counter("t_never_total", "never incremented")
    return r


def test_prometheus_text_and_snapshot_equal_jax():
    port, ref = _script_registry(obs_metrics), _script_registry(jax_metrics)
    assert port.to_prometheus() == ref.to_prometheus()
    assert port.snapshot() == ref.snapshot()
    json.dumps(port.snapshot())
    port.reset()
    assert port.get("t_hits_total").value(kind="warm") == 0.0
    assert port.get("t_live").value() == 7.0        # callbacks survive


def test_family_names_help_units_buckets_equal_jax():
    """Every family the port registers is the JAX package's, with the same
    help, unit, kind and buckets; the JAX package's only extra family is the
    jit trace-entry gauge (obs/metrics.py says why)."""
    import repro_torch.serve.engine  # noqa: F401 (registers its families)

    def families(reg):
        with reg._lock:
            fams = dict(reg._families)
        return {name: (f.kind, f.help, f.unit, getattr(f, "buckets", None))
                for name, f in fams.items() if name.startswith("gila_")}

    port, ref = families(obs_metrics.REGISTRY), families(jax_metrics.REGISTRY)
    assert set(ref) - set(port) == {"gila_jit_trace_entries"}
    assert set(port) <= set(ref)
    for name in port:
        assert port[name] == ref[name], name
    assert len(port) == 20


def test_phase_seconds_thread_safe():
    """Concurrent ``add_phase`` from many threads loses no update."""
    fam = bucketing.PHASE_SECONDS
    before = fam.value(phase="hammer")
    N, K = 8, 2000

    def work():
        for _ in range(K):
            bucketing.add_phase(None, "hammer", 1.0)

    ts = [threading.Thread(target=work) for _ in range(N)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert fam.value(phase="hammer") - before == N * K


# -- the tracer ------------------------------------------------------------------

def test_disabled_tracer_emits_nothing_and_allocates_no_contexts():
    tr = obs_trace.Tracer()
    assert not tr.enabled
    assert tr.span("a") is tr.span("b", x=1)
    with tr.span("a"):
        pass
    tr.instant("i", x=1)
    tr.counter("c", 3)
    tr.complete("r", 0.0, 1.0)
    assert len(tr) == 0
    assert not obs_trace.TRACER.enabled
    assert obs_trace.span("a") is tr.span("b")


def _script_tracer(trace_mod, clock):
    """Nested spans, instants, counters, completes and a named worker
    thread on ``clock`` → the tracer's JSON bytes."""
    tr = trace_mod.Tracer(clock=clock, enabled=True)
    with tr.span("outer", cat="host", level=1):
        clock.advance(1.0)
        with tr.span("inner", key=(64, 512), mode="grid"):
            clock.advance(0.5)
    tr.instant("mark", ts=0.25, rid=3, groups=[(("gila", 64), 2)])
    tr.counter("depth", 2, ts=0.25)
    tr.complete("request", 0.125, 2.0, cat="engine", rid=0)

    def work():
        tr.instant("from-worker", detail={"a": 1})

    t = threading.Thread(target=work, name="engine-worker")
    t.start()
    t.join()
    tr.instant("from-main", obj=object)       # exotic: stringified
    return tr


def test_tracer_export_equals_jax():
    port = _script_tracer(obs_trace, VirtualClock())
    ref = _script_tracer(jax_trace, JaxClock())
    assert port.json_bytes() == ref.json_bytes()
    d = port.to_dict()
    tids = {e["args"]["name"]: e["tid"] for e in d["traceEvents"]
            if e["ph"] == "M" and e["name"] == "thread_name"}
    assert set(tids) == {"MainThread", "engine-worker"}
    by = {e["name"]: e for e in d["traceEvents"] if e["ph"] != "M"}
    assert by["inner"]["ts"] == 1.0e6 and by["inner"]["dur"] == 0.5e6
    assert by["from-worker"]["tid"] == tids["engine-worker"]


# -- padding occupancy ---------------------------------------------------------

def _path_request(n, seed=0):
    edges = np.stack([np.arange(n - 1), np.arange(1, n)], 1)
    g = build_graph(edges, n, bucket=True, device="cpu")
    sched = make_schedule(0, 1, g.n, g.m, exact_threshold=2048,
                          grid_threshold=32768, coarsest_iters=5,
                          ideal_len=1.0, n_pad=g.n_pad)
    pos0 = torch.zeros((g.n_pad, 2), dtype=torch.float32)
    return bucketing.make_request(g, pos0, sched, seed)


def test_padding_occupancy_gauges_match_hand_computed():
    """A mixed-bucket 3-graph wave: two paths share the n64 lane bucket,
    the third lands in n128; the gauges equal true/padded exactly
    (``tests/test_obs.py``'s hand-computed values)."""
    r1, r2, r3 = _path_request(10), _path_request(20), _path_request(100)
    assert bucketing.group_key(r1) == bucketing.group_key(r2)
    assert bucketing.group_key(r3) != bucketing.group_key(r1)
    bucketing.refine_level_many([r1, r2], ideal_len=1.0, rep_const=1.0)
    lanes = 8                                       # lane_bucket(2, 8)
    n_pad, m_pad = r1.g.n_pad, r1.g.m_pad
    assert (n_pad, m_pad) == (bucket_pad(10, 64), bucket_pad(2 * 9, 512))
    reg = obs_metrics.REGISTRY
    occ_v = reg.get("gila_wave_padding_occupancy_vertices")
    occ_e = reg.get("gila_wave_padding_occupancy_edges")
    occ_l = reg.get("gila_wave_lane_occupancy")
    b = f"n{n_pad}_e{m_pad}"
    assert occ_v.value(bucket=b) == (10 + 20) / (lanes * n_pad)
    assert occ_e.value(bucket=b) == (2 * 9 + 2 * 19) / (lanes * m_pad)
    assert occ_l.value(bucket=b) == 2 / lanes
    bucketing.refine_level_many([r3], ideal_len=1.0, rep_const=1.0)
    b3 = f"n{r3.g.n_pad}_e{r3.g.m_pad}"
    assert r3.g.n_pad == 128
    assert occ_v.value(bucket=b3) == 100 / (8 * r3.g.n_pad)
    assert occ_l.value(bucket=b3) == 1 / 8


# -- the engine's scheduling log and trace under null_dispatch -----------------

def _scripted_events(mod):
    out = []
    for i in range(5):
        e, n = G.gnp(24 + 4 * i, 2.0, 50 + i)
        out.append(mod.SimEvent(t=0.02 * i, edges=e, n=n, seed=i,
                                priority=i % 2))
    # one doomed request: its deadline has passed at delivery
    e, n = G.gnp(30, 2.0, 99)
    out.append(mod.SimEvent(t=0.01, edges=e, n=n, seed=9, deadline_s=0.0))
    # cancelled at its own arrival time: delivered after it, so queued
    out.append(mod.SimEvent(t=0.06, kind="cancel", ref=3))
    return out


def _run_traced_sim(mod, trace_mod, clock_cls, cfg, **kw):
    vc = clock_cls()
    tr = trace_mod.Tracer(clock=vc, enabled=True)
    core = mod.EngineCore(cfg, clock=vc, max_lanes=4, wave_lanes=2,
                          dispatch=mod.null_dispatch, tracer=tr, **kw)
    mod.run_sim(core, _scripted_events(mod))
    return core, tr


def _port_sim():
    return _run_traced_sim(port_engine, obs_trace, VirtualClock,
                           LayoutConfig(seed=0), device="cpu")


def test_engine_sim_log_and_trace_equal_jax():
    core, tr = _port_sim()
    ref_core, ref_tr = _run_traced_sim(jax_engine, jax_trace, JaxClock,
                                       JaxConfig(seed=0))
    assert core.log == ref_core.log
    assert core.counters == ref_core.counters
    assert tr.json_bytes() == ref_tr.json_bytes()
    names = {e["name"] for e in json.loads(tr.json_bytes())["traceEvents"]}
    for expected in ("engine.submit", "engine.admit", "engine.complete",
                     "engine.expire", "engine.cancel", "wave",
                     "refine.group", "refine", "request",
                     "engine.queue_depth"):
        assert expected in names, expected


def test_run_sim_replays_byte_identical():
    (c1, t1), (c2, t2) = _port_sim(), _port_sim()
    assert c1.log == c2.log and len(c1.log) > 10
    assert t1.json_bytes() == t2.json_bytes()


def test_engine_stats_snapshot_against_scripted_trace():
    fam = obs_metrics.REGISTRY.get("gila_engine_requests_total")
    waves = obs_metrics.REGISTRY.get("gila_waves_total")
    before, w0 = dict(fam.values()), waves.value()
    core, tr = _port_sim()
    s = core.stats()
    assert s["completed"] == 4 and s["expired"] == 1 and s["cancelled"] == 1
    assert s["queued"] == 0 and s["running"] == 0
    assert s["straggler_waves"] == 0        # VirtualClock waves take 0 s
    snap = s["metrics"]["gila_engine_requests_total"]["values"]
    for event, want in (("submitted", 6), ("completed", 4), ("expired", 1),
                        ("cancelled", 1)):
        delta = snap[f'event="{event}"'] - before.get((("event", event),), 0.0)
        assert delta == want, (event, delta)
    wave_spans = sum(e["name"] == "wave"
                     for e in json.loads(tr.json_bytes())["traceEvents"])
    assert wave_spans == waves.value() - w0 == core.counters["waves"]
    json.dumps(s["metrics"])


# -- launch counts under threads ------------------------------------------------

def test_launch_counts_keep_apart_a_capturing_thread():
    """A capture in progress on one thread records that thread's launches
    only; another thread's launches meanwhile land in the global counts."""
    _build.launches.clear()
    _build.shape_launches.clear()
    inside, go = threading.Event(), threading.Event()
    made = {}

    def capture():
        with _build.capturing() as m:
            _build.count("captured", 4)
            inside.set()
            go.wait(10)
            _build.count("captured", 4)
        made["m"] = m

    t = threading.Thread(target=capture)
    t.start()
    inside.wait(10)
    for _ in range(5):
        _build.count("other", 8)
    go.set()
    t.join()
    assert dict(_build.launches) == {"other": 5}
    assert dict(made["m"][0]) == {"captured": 2}
    assert dict(made["m"][1]) == {("captured", 4): 2}
    _build.replayed(made["m"])
    assert dict(_build.launches) == {"other": 5, "captured": 2}
    assert _build.shape_launches[("other", 8)] == 5
    _build.launches.clear()
    _build.shape_launches.clear()
