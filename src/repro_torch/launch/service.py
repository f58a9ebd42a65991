"""HTTP front door for the continuous-batching layout engine: the JAX
package's ``launch/service.py`` on the port.

A thin stdlib ``http.server`` layer over
``serve.engine.ContinuousLayoutService``: every user's graph laid out on
demand by one always-on engine on the card (``--device cpu`` for the plain
PyTorch versions), requests joining the wave scheduler mid-flight.

    PYTHONPATH=src python -m repro_torch.launch.service --port 8080

    POST /layout   {"edges": [[u, v], ...], "n": 123, "priority": 0,
                    "deadline_s": 30.0, "seed": 7, "engine": "stress"}
        → 200 {"rid", "pos": [[x, y], ...], "levels", "latency_s"}
        → 400 malformed graph            (validation at the boundary)
        → 429 admission queue full       (bounded-queue backpressure)
        → 504 deadline exceeded / timeout
    GET  /healthz  → 200 ok
    GET  /stats    → engine counters + step-cache stats (JSON)
    GET  /metrics  → Prometheus text exposition of the metrics registry
                     (cache hit/miss, padding occupancy, queue depth,
                     latency histograms)

``--trace out.json`` enables the span tracer for the server's lifetime and
writes a Chrome/Perfetto trace-event timeline on shutdown.

``--smoke`` starts the server on an ephemeral port, POSTs three graphs,
holds each response to a dedicated ``multigila_layout`` call
(``hold_to_dedicated``) and checks ``/stats`` and ``/metrics``, then shuts
down; with ``--trace`` it also writes the trace and parses it back.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import threading
from concurrent.futures import CancelledError
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

# a served layout against a dedicated ``multigila_layout`` call of the same
# graph and seed. On the CPU: bit for bit. On the card the placer and the
# dedicated driver sum with ``index_add_`` atomics while the engine's
# batched lanes gather, so the final positions are chaotic there: the
# hierarchy must be bit-equal, NELD within NELD_DELTA, and CRE is held to
# its own spread over the seed, the gap between the dedicated calls at the
# seed and at the seed moved by SPREAD_SEED. A request's CRE gap past
# max(CRE_DELTA, CRE_SPREAD_MULT × the median of those seed gaps) counts as
# out, and no more requests may be out than seed gaps are past that bound;
# the requests' mean CRE gap stays within max(CRE_MEAN_DELTA, CRE_MEAN_SES
# standard errors). The batched driver's rule (chip_smoke.py phase 7) holds
# every lane within the bound instead; on graphs of 90–420 vertices the
# chaos has a long tail that rule does not allow for: on an NVIDIA H100
# 80GB HBM3 (700 W), two dedicated calls of one seed differed by up to
# 0.14, a served request from its dedicated call by 0.26 and from the
# batched driver's run by 0.42, while 7 of 60 seed gaps passed 0.15 (their
# median 0.04)
NELD_DELTA, CRE_DELTA = 0.05, 0.15
CRE_SPREAD_MULT, CRE_MEAN_DELTA, CRE_MEAN_SES = 2.0, 0.05, 4.0
SPREAD_SEED = 1


def make_server(svc, host: str = "127.0.0.1", port: int = 0,
                default_timeout_s: float = 300.0) -> ThreadingHTTPServer:
    """Build (but do not start) the HTTP server wrapping ``svc``.

    ``ThreadingHTTPServer`` gives one thread per connection, so a handler
    blocking on its request's Future stalls nobody else — the engine
    worker keeps admitting other requests between waves.
    """
    from repro_torch.serve.engine import DeadlineExceeded, EngineBusy

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):       # quiet: logs stay readable
            pass

        def _json(self, code: int, payload: dict) -> None:
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {"ok": True})
            elif self.path == "/stats":
                from repro_torch.core import bucketing
                self._json(200, {"engine": svc.stats(),
                                 "compile_cache": bucketing.cache_stats()})
            elif self.path == "/metrics":
                from repro_torch.obs import metrics as obs_metrics
                body = obs_metrics.REGISTRY.to_prometheus().encode()
                self.send_response(200)
                self.send_header("Content-Type",
                                 "text/plain; version=0.0.4; charset=utf-8")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
            else:
                self._json(404, {"error": f"no route {self.path}"})

        def do_POST(self):
            if self.path != "/layout":
                self._json(404, {"error": f"no route {self.path}"})
                return
            try:
                size = int(self.headers.get("Content-Length", "0"))
                body = json.loads(self.rfile.read(size) or b"{}")
                edges = np.asarray(body.get("edges", []), dtype=np.int64)
                n = body["n"]
                timeout = float(body.get("timeout_s", default_timeout_s))
            except (KeyError, ValueError, TypeError, json.JSONDecodeError) as e:
                self._json(400, {"error": f"bad request: {e}"})
                return
            try:
                req = svc.submit(
                    edges, n, priority=int(body.get("priority", 0)),
                    deadline_s=body.get("deadline_s"),
                    seed=body.get("seed"),
                    engine=body.get("engine"))
            except ValueError as e:
                self._json(400, {"error": str(e)})
                return
            except EngineBusy as e:
                self._json(429, {"error": str(e)})
                return
            try:
                pos, stats = req.result(timeout)
            except DeadlineExceeded as e:
                self._json(504, {"error": str(e), "rid": req.rid})
                return
            except CancelledError:
                self._json(409, {"error": "request cancelled",
                                 "rid": req.rid})
                return
            except TimeoutError:
                svc.cancel(req)
                self._json(504, {"error": f"no result in {timeout}s",
                                 "rid": req.rid})
                return
            self._json(200, {"rid": req.rid,
                             "pos": np.asarray(pos, np.float32).tolist(),
                             "levels": stats.levels,
                             "latency_s": round(req.latency or 0.0, 6)})

    return ThreadingHTTPServer((host, port), Handler)


def _hierarchies_equal(a, b) -> bool:
    """Two ``_ComponentTask``s' hierarchies: level sizes and every coarse
    graph and ``LevelInfo`` array equal, bit for bit."""
    (ga, ia), (gb, ib) = (a.graphs or [], a.infos or []), (b.graphs or [],
                                                          b.infos or [])
    if [(g.n, g.m) for g in ga] != [(g.n, g.m) for g in gb]:
        return False
    pairs = ([(getattr(x, f), getattr(y, f)) for x, y in zip(ia, ib)
              for f in ("parent_coarse", "sun_of", "depth", "state",
                        "sun_pos_index")]
             + [(getattr(x, f), getattr(y, f)) for x, y in zip(ga, gb)
                for f in ("src", "dst", "vmask", "emask", "mass", "ewt")])
    return all(np.array_equal(x.cpu().numpy(), y.cpu().numpy())
               for x, y in pairs)


def hold_to_dedicated(requests, cfg, device) -> dict:
    """Hold served layouts to dedicated ``multigila_layout`` calls.

    ``requests``: one ``(edges, n, seed, pos, job)`` a served layout, with
    ``job`` the engine's ``GraphJob`` (its hierarchy; None to skip that
    check). On the CPU each ``pos`` must equal the dedicated call's bit for
    bit; on the card the rule above this module's constants applies.
    Returns the comparison's numbers; raises ``AssertionError`` where the
    requests fail it."""
    from repro_torch.core import multigila_layout
    from repro_torch.core.multilevel import _ComponentTask, _components
    from repro_torch.graphs.metrics import cre, neld
    from repro_torch.utils.device import resolve_device

    dev = resolve_device(device)
    run = lambda e, n, s: multigila_layout(
        e, n, dataclasses.replace(cfg, seed=int(s)), device=dev)[0]
    ref = [run(e, n, s) for e, n, s, _, _ in requests]
    for i, (e, n, s, pos, job) in enumerate(requests):
        if np.asarray(pos).shape != (n, 2) or not np.isfinite(pos).all():
            raise AssertionError(f"request {i}: positions not finite")
        if job is None:
            continue
        scfg = dataclasses.replace(cfg, seed=int(s))
        for (vs, ce, cw), task in zip(_components(np.asarray(e), n, None),
                                      job.tasks):
            own = _ComponentTask(ce, vs.size, scfg, device=dev, weights=cw)
            if not _hierarchies_equal(task, own):
                raise AssertionError(f"request {i}: hierarchy differs from "
                                     f"the dedicated call's")
    if dev.type != "cuda":
        for i, ((*_, pos, _), r) in enumerate(zip(requests, ref)):
            if not np.array_equal(np.asarray(pos, np.float32), r):
                raise AssertionError(f"request {i}: not the dedicated "
                                     f"call's bits")
        return dict(requests=len(requests), bit_equal=True)
    moved = [run(e, n, s + SPREAD_SEED) for e, n, s, _, _ in requests]
    neld_gap = [abs(neld(pos, e) - neld(r, e))
                for (e, _, _, pos, _), r in zip(requests, ref)]
    d = np.array([cre(pos, e) - cre(r, e)
                  for (e, _, _, pos, _), r in zip(requests, ref)])
    seed_gap = np.array([abs(cre(r, e) - cre(m, e))
                         for (e, *_), r, m in zip(requests, ref, moved)])
    spread = float(np.median(seed_gap))
    bound = max(CRE_DELTA, CRE_SPREAD_MULT * spread)
    se = float(d.std(ddof=1) / len(d) ** 0.5) if len(d) > 1 else 0.0
    res = dict(requests=len(requests), max_neld_diff=max(neld_gap),
               max_cre_diff=float(np.abs(d).max()), cre_spread=spread,
               lane_cre_bound=bound,
               requests_out=int((np.abs(d) > bound).sum()),
               seed_gaps_out=int((seed_gap > bound).sum()),
               max_seed_gap=float(seed_gap.max()),
               mean_cre_diff=abs(float(d.mean())), mean_cre_se=se,
               mean_cre_bound=max(CRE_MEAN_DELTA, CRE_MEAN_SES * se),
               hierarchies_equal=True)
    if res["max_neld_diff"] > NELD_DELTA:
        raise AssertionError(f"NELD {res['max_neld_diff']} apart")
    if (res["requests_out"] > res["seed_gaps_out"]
            or res["mean_cre_diff"] > res["mean_cre_bound"]):
        raise AssertionError(f"CRE: {res['requests_out']} requests past "
                             f"{bound} (the seed moved: "
                             f"{res['seed_gaps_out']}), the mean "
                             f"{res['mean_cre_diff']} (bound "
                             f"{res['mean_cre_bound']}) apart")
    return res


def smoke(device=None, trace: str = "") -> dict:
    """Self-test: serve three graphs over HTTP, hold each to a dedicated
    call (``hold_to_dedicated``), check ``/stats`` and ``/metrics``; with
    ``trace``, record the run and write, then parse, the trace file."""
    import urllib.request

    from repro_torch.core import LayoutConfig
    from repro_torch.graphs import generators as G
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.engine import ContinuousLayoutService

    cfg = LayoutConfig(seed=0)
    if trace:
        obs_trace.reset()
        obs_trace.enable()
    svc = ContinuousLayoutService(cfg, max_lanes=8, device=device)
    # keep each admitted job, for its hierarchy (the engine drops finished
    # requests)
    jobs = {}
    admit = svc.core.sched.admit

    def keep(edges, n, **kw):
        jobs[kw["seed"]] = job = admit(edges, n, **kw)
        return job

    svc.core.sched.admit = keep
    httpd = make_server(svc)
    host, port = httpd.server_address
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    try:
        graphs = [G.delaunay(90, 7 + i) for i in range(3)]
        served = []
        for i, (e, n) in enumerate(graphs):
            payload = json.dumps({"edges": e.tolist(), "n": int(n),
                                  "seed": 7 + i}).encode()
            with urllib.request.urlopen(
                    f"http://{host}:{port}/layout", data=payload,
                    timeout=600) as resp:
                out = json.loads(resp.read())
            served.append((e, n, 7 + i, np.asarray(out["pos"], np.float32),
                           jobs[7 + i]))
            print(f"[service] graph {i}: n={n} levels={out['levels']} "
                  f"latency={out['latency_s']}s", flush=True)
        with urllib.request.urlopen(f"http://{host}:{port}/stats",
                                    timeout=60) as resp:
            stats = json.loads(resp.read())
        if stats["engine"]["completed"] != 3:
            raise AssertionError(f"{stats['engine']['completed']} completed")
        with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                    timeout=60) as resp:
            prom = resp.read().decode()
        for series in ("gila_compile_cache_hits_total",
                       "gila_wave_padding_occupancy_vertices"):
            if series not in prom:
                raise AssertionError(f"/metrics has no {series}")
    finally:
        httpd.shutdown()
        svc.close()
        if trace:
            obs_trace.disable()
    parity = hold_to_dedicated(served, cfg, svc.core.sched.device)
    eng = {k: v for k, v in stats["engine"].items() if k != "metrics"}
    res = dict(engine=eng, parity=parity)
    if trace:
        obs_trace.export(trace)
        with open(trace) as f:
            events = json.load(f)["traceEvents"]
        res["trace_events"] = len(events)
        res["trace_waves"] = sum(e["name"] == "wave" for e in events)
        if not res["trace_waves"]:
            raise AssertionError(f"{trace}: no wave span")
    print(f"[service] smoke OK: {res}", flush=True)
    return res


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=8080)
    ap.add_argument("--max-lanes", type=int, default=32,
                    help="concurrent component lanes the engine runs")
    ap.add_argument("--max-queue", type=int, default=256,
                    help="admission queue bound (backpressure above it)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="torch device of the layouts (default cuda)")
    ap.add_argument("--trace", default="", metavar="OUT.json",
                    help="record a Chrome/Perfetto trace for the server's "
                         "lifetime; written on shutdown")
    ap.add_argument("--smoke", action="store_true",
                    help="serve 3 graphs over HTTP on an ephemeral port, "
                         "hold them to dedicated calls, exit")
    args = ap.parse_args(argv)
    if args.smoke:
        smoke(args.device, args.trace)
        return

    from repro_torch.core import LayoutConfig
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve.engine import ContinuousLayoutService

    if args.trace:
        obs_trace.enable()
    svc = ContinuousLayoutService(LayoutConfig(seed=args.seed),
                                  max_queue=args.max_queue,
                                  max_lanes=args.max_lanes,
                                  device=args.device)
    httpd = make_server(svc, host=args.host, port=args.port)
    print(f"[service] continuous-batching layout engine on "
          f"http://{args.host}:{httpd.server_address[1]} "
          f"(max_lanes={args.max_lanes}, max_queue={args.max_queue}, "
          f"device={svc.core.sched.device})", flush=True)
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.shutdown()
        svc.close()
        if args.trace:
            obs_trace.export(args.trace)
            print(f"[service] wrote trace to {args.trace}", flush=True)


if __name__ == "__main__":
    main()
