"""Structured span tracer with Chrome/Perfetto trace-event export: the JAX
package's ``obs/trace.py`` (no JAX in it), copied.

One process-wide ``Tracer`` collects *spans* (named, nested intervals),
*instant events* (point markers: the engine's scheduling log rides the same
timeline as the device dispatch spans) and *counter samples* (queue depth
over time). ``export`` writes the Chrome trace-event JSON that
``chrome://tracing`` and https://ui.perfetto.dev load, so a
``--trace out.json`` run of a driver becomes a timeline on which host
coarsening, placement, refine dispatches and engine waves overlay.

Design constraints, in order:

  * **~zero cost when disabled.** Every hook checks one attribute and
    returns a single shared ``nullcontext``: no allocation, no clock read,
    no lock. The port's hooks add no device synchronize when the tracer is
    off; when it is on, a device-dispatch span ends with one, so that it
    holds the device time of its work.
  * **Time through the Clock seam only** (obs/clock.py). Under a
    ``VirtualClock`` the same scripted service run replays to a
    byte-identical trace file: timestamps are virtual, the pid is fixed,
    and tids are assigned from thread-NAME first-appearance order rather
    than OS thread ids.
  * **Thread-aware.** Events record the emitting thread's name, so the
    engine worker thread (named ``engine-worker``) and the caller thread
    render as separate tracks.

Spans must close on the thread that opened them (the usual
``with span(...)`` shape guarantees it); cross-thread intervals are
emitted with explicit times via ``complete``.
"""
from __future__ import annotations

import contextlib
import json
import threading

from repro_torch.obs.clock import Clock, SystemClock

# the shared do-nothing context manager: the disabled-tracer fast path
# returns THIS object every time (identity-asserted in tests/test_torch_obs.py)
_NULL = contextlib.nullcontext()


def _json_safe(v):
    """Clamp span/instant args to JSON-able values (tuples → lists,
    anything exotic → ``str``) so export never throws mid-benchmark."""
    if v is None or isinstance(v, (bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_json_safe(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _json_safe(x) for k, x in v.items()}
    return str(v)


class _Span:
    """Context object for one open span; created only when tracing is ON."""

    __slots__ = ("_tr", "_name", "_cat", "_args", "_t0")

    def __init__(self, tr: "Tracer", name: str, cat: str, args: dict):
        self._tr = tr
        self._name = name
        self._cat = cat
        self._args = args

    def __enter__(self):
        self._t0 = self._tr.clock.now()
        return self

    def __exit__(self, *exc):
        tr = self._tr
        tr._append("X", self._name, self._cat, self._t0,
                   tr.clock.now() - self._t0, self._args)
        return False


class Tracer:
    """Span/instant/counter collector bound to one ``Clock``.

    The module-level ``TRACER`` is the process default (SystemClock,
    disabled); tests and the sim rig construct their own on a
    ``VirtualClock``. All mutation is lock-protected — hooks fire from
    the engine worker thread and the caller thread concurrently.
    """

    def __init__(self, clock: Clock | None = None, *, enabled: bool = False):
        self.clock = clock or SystemClock()
        self.enabled = bool(enabled)
        self._lock = threading.Lock()
        # (ph, name, cat, t_seconds, dur_seconds, thread_name, args)
        self._events: list[tuple] = []

    # -- control ---------------------------------------------------------------
    def enable(self, clock: Clock | None = None) -> None:
        if clock is not None:
            self.clock = clock
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def reset(self) -> None:
        with self._lock:
            self._events.clear()

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)

    # -- hooks (each is a no-op returning shared state when disabled) ----------
    def span(self, name: str, cat: str = "", **args):
        """``with tracer.span("coarsen", level=3): ...`` — a nested
        interval on the calling thread's track."""
        if not self.enabled:
            return _NULL
        return _Span(self, name, cat, args)

    def complete(self, name: str, t0: float, t1: float, cat: str = "",
                 **args) -> None:
        """A finished interval with explicit clock-frame times — for
        spans whose bounds were observed elsewhere (request lifetimes,
        per-lane shares of a fused group dispatch)."""
        if not self.enabled:
            return
        self._append("X", name, cat, float(t0), float(t1) - float(t0), args)

    def instant(self, name: str, ts: float | None = None, cat: str = "",
                **args) -> None:
        if not self.enabled:
            return
        t = self.clock.now() if ts is None else float(ts)
        self._append("i", name, cat, t, None, args)

    def counter(self, name: str, value, ts: float | None = None) -> None:
        """One sample of a time-series counter track (e.g. queue depth)."""
        if not self.enabled:
            return
        t = self.clock.now() if ts is None else float(ts)
        self._append("C", name, "", t, None, {"value": value})

    def _append(self, ph: str, name: str, cat: str, t: float,
                dur: float | None, args: dict) -> None:
        ev = (ph, name, cat, t, dur, threading.current_thread().name,
              {k: _json_safe(v) for k, v in args.items()} if args else None)
        with self._lock:
            self._events.append(ev)

    # -- export ----------------------------------------------------------------
    def to_dict(self) -> dict:
        """Chrome trace-event JSON object. Deterministic by construction:
        ``pid`` is always 1 (never ``os.getpid()``), ``tid`` is the
        first-appearance rank of the thread NAME, timestamps are the
        recorded clock readings in µs rounded to ns."""
        with self._lock:
            events = list(self._events)
        tids: dict[str, int] = {}
        out = [{"ph": "M", "pid": 1, "tid": 0, "name": "process_name",
                "args": {"name": "repro"}}]
        body = []
        for ph, name, cat, t, dur, tname, args in events:
            tid = tids.get(tname)
            if tid is None:
                tid = tids[tname] = len(tids) + 1
                out.append({"ph": "M", "pid": 1, "tid": tid,
                            "name": "thread_name", "args": {"name": tname}})
            ev = {"ph": ph, "pid": 1, "tid": tid, "name": name,
                  "ts": round(t * 1e6, 3)}
            if cat:
                ev["cat"] = cat
            if ph == "X":
                ev["dur"] = round((dur or 0.0) * 1e6, 3)
            if ph == "i":
                ev["s"] = "t"                   # thread-scoped instant
            if args:
                ev["args"] = args
            body.append(ev)
        return {"traceEvents": out + body, "displayTimeUnit": "ms"}

    def json_bytes(self) -> bytes:
        return json.dumps(self.to_dict(), sort_keys=True,
                          separators=(",", ":")).encode("utf-8")

    def export(self, path: str) -> str:
        with open(path, "wb") as f:
            f.write(self.json_bytes())
        return path


# -- the process-default tracer and its module-level hook surface --------------

TRACER = Tracer()


def get_tracer() -> Tracer:
    return TRACER


def span(name: str, cat: str = "", **args):
    return _NULL if not TRACER.enabled else _Span(TRACER, name, cat, args)


def complete(name: str, t0: float, t1: float, cat: str = "", **args) -> None:
    TRACER.complete(name, t0, t1, cat, **args)


def instant(name: str, ts: float | None = None, cat: str = "", **args) -> None:
    TRACER.instant(name, ts, cat, **args)


def counter(name: str, value, ts: float | None = None) -> None:
    TRACER.counter(name, value, ts)


def enable(clock: Clock | None = None) -> None:
    TRACER.enable(clock)


def disable() -> None:
    TRACER.disable()


def reset() -> None:
    TRACER.reset()


def export(path: str) -> str:
    return TRACER.export(path)
