"""Layout-as-a-service front door: micro-batched multi-graph layout, the
JAX package's ``serve/layout_service.py`` on the port.

Many users submit (small) graphs concurrently and each expects a finished
drawing back. One ``LayoutService`` owns a deadline-window collector (the
``_BatcherCore`` machinery of serve/batcher.py) whose batches are evaluated
by ``core.multilevel.multigila_layout_many`` on ``device`` (default: the
card), so every window of concurrent requests shares one batched program
per shape bucket a level wave, and a warm process captures nothing
(core/bucketing.py). Each result equals a dedicated ``multigila_layout``
call's (bit for bit on the CPU).

    svc = LayoutService(LayoutConfig(seed=0))
    futs = [svc.submit(edges_i, n_i) for ...]     # concurrent callers
    pos, stats = futs[0].result()
    svc.close()

The default window (10 ms) is wider than the viewport batcher's: a layout
costs 10⁴–10⁶× a tile lookup, so waiting a beat longer to fill the batch
is worth it.
"""
from __future__ import annotations

from concurrent.futures import Future

from repro_torch.utils.device import resolve_device

from repro_torch.serve.batcher import _BatcherCore


class LayoutService(_BatcherCore):
    """Deadline-window coalescing of layout requests into batched drivers."""

    def __init__(self, cfg=None, *, max_batch: int = 16,
                 window_s: float = 0.010, device=None):
        from repro_torch.core import LayoutConfig
        self.cfg = cfg or LayoutConfig()
        self.device = resolve_device(device)
        super().__init__(max_batch=max_batch, window_s=window_s)

    def submit(self, edges, n: int) -> Future:
        """Enqueue one graph; resolves to ``(pos[n, 2], LayoutStats)``.

        Validates — and defensively copies — the request HERE, not in the
        batch (serve/engine.py:validate_graph): requests coalesce into
        shared driver calls, so one malformed graph would otherwise fail
        (or, with negative ids wrapping, silently corrupt) every request
        in its window, and a caller mutating its edge array after submit
        would corrupt the shared batch.
        """
        from repro_torch.serve.engine import validate_graph
        e, n = validate_graph(edges, n)
        return self._submit_payload((e, n))

    def layout(self, edges, n: int, timeout: float | None = None):
        """Blocking convenience wrapper around ``submit``."""
        return self.submit(edges, n).result(timeout)

    def _execute(self, payloads: list) -> list:
        from repro_torch.core import multigila_layout_many
        return multigila_layout_many(payloads, self.cfg, device=self.device)
