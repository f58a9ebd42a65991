"""Typed counter/gauge/histogram registry with Prometheus text export: the
JAX package's ``obs/metrics.py`` (no JAX in it), copied so that the port's
``GET /metrics`` reads the same.

One process-wide ``REGISTRY`` holds every metric the port emits:
step-cache hits/misses/entries (core/bucketing.py), wave composition and
padding occupancy (core/multilevel.py, ``bucketing.refine_level_many``),
merger rounds (core/solar_merger.py), engine admission/expiry/preemption
counts and latency histograms (serve/engine.py). The family names, help
texts, units and histogram buckets are the JAX package's, with one
exception: ``gila_jit_trace_entries`` (the trace-cache sizes of the JAX
package's jitted functions) has no counterpart, because PyTorch traces
nothing outside the step cache, whose size ``gila_compile_cache_entries``
already reports. Exported two ways:

  * Prometheus text exposition (``to_prometheus``) behind ``GET /metrics``
    on the HTTP front door (launch/service.py);
  * a JSON ``snapshot``, embedded in ``EngineCore.stats()``.

Families register idempotently (``counter(name, ...)`` returns the existing
family) and every mutation takes the registry lock, so the engine worker
thread and a caller thread may feed one family at once (phase seconds are
the labeled counter ``gila_phase_seconds_total{phase=...}``).

Metric names follow Prometheus conventions: ``gila_`` prefix, ``_total``
suffix on counters, base units (seconds, ratios in [0, 1]) in the name or
``unit``.
"""
from __future__ import annotations

import threading


def _label_key(labels: dict) -> tuple:
    return tuple(sorted(labels.items()))


def _label_str(key: tuple) -> str:
    return ",".join(f'{k}="{v}"' for k, v in key)


def _fmt(v: float) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) and abs(f) < 1e15 else repr(f)


class _Family:
    """Base of one named metric family (all label variants of a name)."""

    kind = "untyped"

    def __init__(self, name: str, help: str, unit: str,
                 lock: threading.RLock):
        self.name = name
        self.help = help
        self.unit = unit
        self._lock = lock
        self._values: dict[tuple, float] = {}

    def values(self) -> dict[tuple, float]:
        with self._lock:
            return dict(self._values)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(_label_key(labels), 0.0)

    def clear(self) -> None:
        with self._lock:
            self._values.clear()

    def _snapshot_values(self) -> dict:
        return {_label_str(k): v for k, v in self.values().items()}

    def snapshot(self) -> dict:
        return {"type": self.kind, "unit": self.unit,
                "values": self._snapshot_values()}


class Counter(_Family):
    kind = "counter"

    def inc(self, amount: float = 1.0, **labels) -> None:
        assert amount >= 0, f"counter {self.name} decremented by {amount}"
        k = _label_key(labels)
        with self._lock:
            self._values[k] = self._values.get(k, 0.0) + float(amount)


class Gauge(_Family):
    """Settable gauge; ``fn`` makes it a *callback* gauge sampled at
    read/export time (e.g. live compile-cache entry count)."""

    kind = "gauge"

    def __init__(self, name, help, unit, lock, fn=None):
        super().__init__(name, help, unit, lock)
        self.fn = fn

    def set(self, value: float, **labels) -> None:
        with self._lock:
            self._values[_label_key(labels)] = float(value)

    def values(self) -> dict[tuple, float]:
        if self.fn is not None:
            return {(): float(self.fn())}
        return super().values()

    def value(self, **labels) -> float:
        if self.fn is not None:
            return float(self.fn())
        return super().value(**labels)


class Histogram(_Family):
    """Cumulative-bucket histogram (Prometheus semantics): ``le`` bounds
    are upper-inclusive, ``+Inf`` implicit; per-label-set it tracks
    bucket counts, sum, and count."""

    kind = "histogram"
    DEFAULT_BUCKETS = (0.001, 0.005, 0.01, 0.05, 0.1, 0.25, 0.5, 1.0,
                       2.5, 5.0, 10.0, 30.0, 60.0)

    def __init__(self, name, help, unit, lock, buckets=None):
        super().__init__(name, help, unit, lock)
        self.buckets = tuple(sorted(buckets or self.DEFAULT_BUCKETS))
        # label key -> [bucket_counts..., count, sum]
        self._values: dict[tuple, list] = {}

    def observe(self, value: float, **labels) -> None:
        v = float(value)
        k = _label_key(labels)
        with self._lock:
            row = self._values.get(k)
            if row is None:
                row = self._values[k] = [0] * len(self.buckets) + [0, 0.0]
            for i, le in enumerate(self.buckets):
                if v <= le:
                    row[i] += 1
            row[-2] += 1
            row[-1] += v

    def stats(self, **labels) -> dict:
        with self._lock:
            row = self._values.get(_label_key(labels))
            if row is None:
                return {"count": 0, "sum": 0.0, "buckets": {}}
            return {"count": row[-2], "sum": row[-1],
                    "buckets": {_fmt(le): row[i]
                                for i, le in enumerate(self.buckets)}}

    def _snapshot_values(self) -> dict:
        with self._lock:
            keys = list(self._values)
        return {_label_str(k): self.stats(**dict(k)) for k in keys}


class Registry:
    """Thread-safe metric registry; see module docstring. Registration is
    idempotent get-or-create, so modules can declare their metrics at
    import time in any order."""

    def __init__(self):
        self._lock = threading.RLock()
        self._families: dict[str, _Family] = {}

    def _register(self, cls, name, help, unit, **kw) -> _Family:
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                fam = self._families[name] = cls(name, help, unit,
                                                 self._lock, **kw)
            assert isinstance(fam, cls), \
                f"{name} already registered as {fam.kind}"
            return fam

    def counter(self, name: str, help: str = "", unit: str = "") -> Counter:
        return self._register(Counter, name, help, unit)

    def gauge(self, name: str, help: str = "", unit: str = "",
              fn=None) -> Gauge:
        g = self._register(Gauge, name, help, unit, fn=fn)
        if fn is not None:
            g.fn = fn
        return g

    def histogram(self, name: str, help: str = "", unit: str = "",
                  buckets=None) -> Histogram:
        return self._register(Histogram, name, help, unit, buckets=buckets)

    def get(self, name: str) -> _Family | None:
        with self._lock:
            return self._families.get(name)

    def reset(self) -> None:
        """Zero every family's values (registrations and callbacks stay)."""
        with self._lock:
            for fam in self._families.values():
                fam.clear()

    def snapshot(self) -> dict:
        """JSON-able {name: {type, unit, values}} of every family."""
        with self._lock:
            fams = list(self._families.items())
        return {name: fam.snapshot() for name, fam in sorted(fams)}

    def to_prometheus(self) -> str:
        """Prometheus text exposition format 0.0.4."""
        lines = []
        with self._lock:
            fams = sorted(self._families.items())
        for name, fam in fams:
            if fam.help:
                lines.append(f"# HELP {name} {fam.help}")
            lines.append(f"# TYPE {name} {fam.kind}")
            if isinstance(fam, Histogram):
                with fam._lock:
                    keys = list(fam._values)
                for k in sorted(keys):
                    st = fam.stats(**dict(k))
                    base = _label_str(k)
                    for le in fam.buckets:
                        sep = "," if base else ""
                        lines.append(
                            f'{name}_bucket{{{base}{sep}le="{_fmt(le)}"}}'
                            f' {st["buckets"][_fmt(le)]}')
                    lines.append(
                        f'{name}_bucket{{{base}{"," if base else ""}'
                        f'le="+Inf"}} {st["count"]}')
                    suffix = f"{{{base}}}" if base else ""
                    lines.append(f"{name}_sum{suffix} {_fmt(st['sum'])}")
                    lines.append(f"{name}_count{suffix} {st['count']}")
            else:
                vals = fam.values()
                if not vals and not isinstance(fam, Gauge):
                    lines.append(f"{name} 0")
                for k in sorted(vals):
                    suffix = f"{{{_label_str(k)}}}" if k else ""
                    lines.append(f"{name}{suffix} {_fmt(vals[k])}")
        return "\n".join(lines) + "\n"


REGISTRY = Registry()
