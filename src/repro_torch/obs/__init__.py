"""Observability: span tracing and metrics, the JAX package's ``obs/``.

  * ``obs.clock``   — the ``Clock`` seam (System/Virtual) every timestamp
    in the stack reads through;
  * ``obs.trace``   — structured span tracer exporting Chrome/Perfetto
    trace-event JSON (``--trace out.json`` on the drivers);
  * ``obs.metrics`` — typed counter/gauge/histogram registry exported as
    Prometheus text (``GET /metrics``) and as JSON.

This package sits below core/serve/launch in the import graph (it imports
nothing from them), so any module can instrument itself without cycles.
"""
from repro_torch.obs.clock import Clock, SystemClock, VirtualClock
from repro_torch.obs.trace import TRACER, Tracer, get_tracer
from repro_torch.obs.metrics import REGISTRY, Registry

__all__ = ["Clock", "SystemClock", "VirtualClock", "Tracer", "TRACER",
           "get_tracer", "Registry", "REGISTRY"]
