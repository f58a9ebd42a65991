"""The port's layout services — the continuous-batching ``EngineCore``, its
simulation rig, ``ContinuousLayoutService``, the fixed-window
``LayoutService`` and the HTTP front door — on the CPU.

Scheduling is held to the live JAX engine: each scenario runs the same
script (submits, ticks, clock advances, cancels) through both engines
under a ``VirtualClock`` with ``null_dispatch``, and the two scheduling
logs must be equal entry for entry, besides the scenario's own assertions.
Results of the real dispatch path (mid-flight joins, cancelled siblings,
the front doors) are held to dedicated port ``multigila_layout`` calls bit
for bit, the JAX package's contract on the CPU.
"""
import dataclasses
import json
import threading
import urllib.error
import urllib.request
from concurrent.futures import CancelledError

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.core import LayoutConfig as JaxConfig
from repro.graphs import generators as G
from repro.serve import engine as jax_engine
from repro_torch.core import LayoutConfig, multigila_layout
from repro_torch.launch.service import hold_to_dedicated, make_server
from repro_torch.serve import LayoutService
from repro_torch.serve import engine as port_engine
from repro_torch.serve.engine import (ContinuousLayoutService, EngineCore,
                                      SystemClock, VirtualClock,
                                      null_dispatch, run_sim, validate_graph)

CFG = LayoutConfig(seed=0)


def path_graph(k: int):
    e = np.stack([np.arange(k - 1), np.arange(1, k)], 1).astype(np.int64)
    return e, k


def dedicated(edges, n, seed):
    pos, _ = multigila_layout(edges, n, dataclasses.replace(CFG, seed=seed),
                              device="cpu")
    return pos


def _cores(**kw):
    """(port core, JAX core) on their own VirtualClocks, null_dispatch."""
    port = EngineCore(CFG, clock=VirtualClock(), dispatch=null_dispatch,
                      device="cpu", **kw)
    ref = jax_engine.EngineCore(JaxConfig(seed=0),
                                clock=jax_engine.VirtualClock(),
                                dispatch=jax_engine.null_dispatch, **kw)
    return port, ref


# -- the service boundary ------------------------------------------------------

def test_validate_graph_copies_and_checks():
    e = np.array([[0, 1], [1, 2]], dtype=np.int64)
    out, n = validate_graph(e, 3)
    assert out is not e and np.array_equal(out, e)
    e[:] = 0
    assert np.array_equal(out, [[0, 1], [1, 2]])
    for bad in (([[0, 1]], 0), ([[0, 5]], 3), ([[-1, 0]], 3)):
        with pytest.raises(ValueError):
            validate_graph(*bad)
        with pytest.raises(ValueError):
            jax_engine.validate_graph(*bad)
    with pytest.raises(ValueError):
        EngineCore(CFG, dispatch=null_dispatch, device="cpu").submit(
            *path_graph(4), engine="nope")


# -- scheduling, held to the JAX engine's log ----------------------------------

def _admission_order(core):
    e, n = path_graph(8)
    core.submit(e, n)                          # rid 0: low priority
    core.submit(e, n, priority=2)              # rid 1: high, no deadline
    core.submit(e, n, priority=2, deadline_s=10.0)   # rid 2: high + deadline
    core.submit(e, n, priority=2)              # rid 3: high, later
    core.run_until_idle()
    admits = [rid for _, kind, rid, _ in core.log if kind == "admit"]
    assert admits == [2, 1, 3, 0]              # priority, deadline, FIFO
    assert core.counters["completed"] == 4


def _expiry_queued(core):
    e, n = G.delaunay(60, 1)
    r0 = core.submit(e, n)
    core.tick()                                # r0 admitted, holds the lane
    r1 = core.submit(e, n, deadline_s=0.05)
    core.clock.advance(0.06)
    core.tick()
    assert r1.status == "expired"
    with pytest.raises(Exception) as ei:
        r1.result(0)
    assert type(ei.value).__name__ == "DeadlineExceeded"
    core.run_until_idle()
    assert r0.status == "done"


def _expiry_running(core):
    e, n = G.delaunay(60, 1)
    r0 = core.submit(e, n, deadline_s=0.05)
    r1 = core.submit(e, n, seed=7)
    core.tick()
    assert r0.status == "running"
    core.clock.advance(0.06)
    core.tick()
    assert r0.status == "expired"
    core.run_until_idle()
    assert r1.status == "done"
    assert core.stats()["lanes_live"] == 0


def _preemption(core):
    e, n = G.delaunay(60, 1)
    lo = core.submit(e, n)
    core.tick()                                # lo rides wave 1
    hi = core.submit(e, n, priority=5)
    core.run_until_idle()
    order = [rid for _, k, rid, _ in core.log if k == "complete"]
    assert order == [hi.rid, lo.rid]


def _backpressure(core):
    e, n = path_graph(8)
    core.submit(e, n)
    core.submit(e, n)
    with pytest.raises(Exception) as ei:
        core.submit(e, n)                      # queue full: bounced
    assert type(ei.value).__name__ == "EngineBusy"
    assert core.counters["rejected"] == 1
    core.run_until_idle()
    assert core.counters["completed"] == 2


def _cancel(core):
    e, n = G.delaunay(60, 1)
    r0 = core.submit(e, n)
    r1 = core.submit(e, n)
    core.tick()                                # r0 running, r1 queued
    assert core.cancel(r1) and r1.status == "cancelled"
    assert core.cancel(r0)                     # running: freed at boundary
    core.tick()
    assert r0.status == "cancelled"
    assert core.stats()["lanes_live"] == 0
    with pytest.raises(CancelledError):
        r0.result(0)
    assert not core.cancel(r0)


SCENARIOS = {
    "admission_order": (_admission_order, dict(max_lanes=1)),
    "deadline_queued": (_expiry_queued, dict(max_lanes=1)),
    "deadline_running": (_expiry_running, dict(max_lanes=2)),
    "priority_preemption": (_preemption, dict(max_lanes=4, wave_lanes=1)),
    "backpressure": (_backpressure, dict(max_queue=2, max_lanes=1)),
    "cancel": (_cancel, dict(max_lanes=1)),
}


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_scheduling_log_equals_jax(name):
    script, kw = SCENARIOS[name]
    port, ref = _cores(**kw)
    script(port)
    script(ref)
    assert port.log == ref.log and port.log
    assert port.counters == ref.counters


def test_poisson_trace_log_equals_jax():
    graphs = [path_graph(6), path_graph(12), G.delaunay(30, 2)]
    mk = lambda i, rng: graphs[i % len(graphs)]
    logs = []
    for mod, core in zip((port_engine, jax_engine), _cores(max_queue=4,
                                                           max_lanes=2)):
        trace = mod.poisson_trace(40.0, 14, mk, seed=5, priorities=(0, 1, 2),
                                  deadline_s=0.4)
        trace += [mod.SimEvent(t=0.08, kind="cancel", ref=2),
                  mod.SimEvent(t=0.15, kind="cancel", ref=9)]
        mod.run_sim(core, trace)
        logs.append((list(core.log), dict(core.counters)))
    assert logs[0] == logs[1] and len(logs[0][0]) > 20
    assert logs[0][1]["submitted"] == 14


def test_run_sim_requires_virtual_clock():
    core = EngineCore(CFG, clock=SystemClock(), dispatch=null_dispatch,
                      device="cpu")
    with pytest.raises(TypeError):
        run_sim(core, [])


# -- the real dispatch path: bit for bit against dedicated calls ---------------

def test_mid_flight_join_and_cancel_keep_siblings_bits():
    core = EngineCore(CFG, clock=VirtualClock(), max_lanes=8, device="cpu")
    graphs = [G.delaunay(50, 20), G.delaunay(72, 21), G.delaunay(50, 22),
              G.delaunay(72, 12)]
    reqs = [core.submit(e, n, seed=20 + i)
            for i, (e, n) in enumerate(graphs[:3])]
    core.tick()                                # everyone mid-flight
    core.cancel(reqs[1])
    late = core.submit(*graphs[3], seed=23)    # joins the next wave
    core.run_until_idle()
    assert reqs[1].status == "cancelled"
    assert core.stats()["lanes_live"] == 0
    for i, req in ((0, reqs[0]), (2, reqs[2]), (3, late)):
        pos, _ = req.result(0)
        assert np.array_equal(pos, dedicated(*graphs[i], 20 + i)), i
    # the engine's hierarchies are the dedicated calls' too
    served = [(*graphs[i], 20 + i, r.result(0)[0], r.job)
              for i, r in ((0, reqs[0]), (2, reqs[2]), (3, late))]
    assert hold_to_dedicated(served, CFG, "cpu")["bit_equal"]


def test_continuous_service_mutation_after_submit():
    e, n = G.delaunay(40, 3)
    ref = dedicated(e, n, CFG.seed)
    svc = ContinuousLayoutService(CFG, max_lanes=4, device="cpu")
    try:
        req = svc.submit(e, n)
        e[:] = 0
        pos, _ = req.result(300)
    finally:
        svc.close()
    assert np.array_equal(pos, ref)
    with pytest.raises(RuntimeError):
        svc.submit(*G.delaunay(40, 3))


# -- the fixed-window batcher -------------------------------------------------

def test_batcher_max_batch_one_and_mutation_after_submit():
    e, n = G.delaunay(40, 3)
    ref = dedicated(e, n, CFG.seed)
    svc = LayoutService(CFG, max_batch=1, window_s=0.0, device="cpu")
    try:
        futs = [svc.submit(e, n) for _ in range(3)]
        e[:] = 0                               # scramble after submit
        for f in futs:
            assert np.array_equal(f.result(300)[0], ref)
    finally:
        svc.close()


def test_batcher_close_drains_then_refuses():
    e, n = G.delaunay(40, 3)
    svc = LayoutService(CFG, max_batch=4, window_s=5.0, device="cpu")
    futs = [svc.submit(e, n) for _ in range(3)]
    svc.close()                                # must flush, not drop
    for f in futs:
        assert np.asarray(f.result(0)[0]).shape == (n, 2)
    assert svc.batches == 1 and svc.requests == 3
    with pytest.raises(RuntimeError):
        svc.submit(e, n)


# -- the HTTP front door -------------------------------------------------------

def test_http_round_trip():
    svc = ContinuousLayoutService(CFG, max_lanes=4, device="cpu")
    httpd = make_server(svc)
    host, port = httpd.server_address
    threading.Thread(target=httpd.serve_forever, daemon=True).start()
    base = f"http://{host}:{port}"
    try:
        e, n = G.delaunay(40, 3)
        body = json.dumps({"edges": e.tolist(), "n": int(n),
                           "seed": 9}).encode()
        with urllib.request.urlopen(f"{base}/layout", data=body,
                                    timeout=300) as resp:
            out = json.loads(resp.read())
        assert np.array_equal(np.asarray(out["pos"], np.float32),
                              dedicated(e, n, 9))
        with urllib.request.urlopen(f"{base}/healthz", timeout=30) as resp:
            assert json.loads(resp.read()) == {"ok": True}
        with urllib.request.urlopen(f"{base}/stats", timeout=30) as resp:
            stats = json.loads(resp.read())
        assert stats["engine"]["completed"] == 1
        assert "misses" in stats["compile_cache"]
        with urllib.request.urlopen(f"{base}/metrics", timeout=30) as resp:
            assert resp.headers["Content-Type"].startswith("text/plain")
            text = resp.read().decode()
        samples = {}
        for line in text.strip().splitlines():
            if not line.startswith("#"):
                name, value = line.rsplit(" ", 1)
                samples[name] = float(value)
        assert samples["gila_compile_cache_misses_total"] >= 1
        occ = [v for k, v in samples.items()
               if k.startswith("gila_wave_padding_occupancy_vertices")]
        assert occ and all(0.0 < v <= 1.0 for v in occ)
        assert any(k.startswith("gila_request_latency_seconds_bucket")
                   for k in samples)
        for bad, code in ((json.dumps({"edges": [[0, 99]], "n": 3}), 400),
                          (json.dumps({"edges": [], "n": 2,
                                       "engine": "nope"}), 400)):
            with pytest.raises(urllib.error.HTTPError) as ei:
                urllib.request.urlopen(f"{base}/layout", data=bad.encode(),
                                       timeout=30)
            assert ei.value.code == code
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(f"{base}/nowhere", data=b"{}", timeout=30)
        assert ei.value.code == 404
    finally:
        httpd.shutdown()
        svc.close()


def test_service_cli_smoke_with_trace(tmp_path):
    """``launch/service.py --smoke --trace`` with ``--device cpu``: three
    graphs over HTTP, each bit-equal to a dedicated call, and a trace file
    that parses, with a ``wave`` span a dispatched wave."""
    from repro_torch.launch import service
    from repro_torch.obs import trace as obs_trace
    path = str(tmp_path / "trace.json")
    service.main(["--smoke", "--device", "cpu", "--trace", path])
    assert not obs_trace.TRACER.enabled
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e["name"] for e in events}
    assert {"wave", "refine.group", "refine", "coarsen", "place",
            "refine_many.dispatch", "engine.admit", "request"} <= names
    obs_trace.reset()
