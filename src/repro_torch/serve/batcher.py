"""Micro-batching front doors: the JAX package's ``serve/batcher.py``.

Concurrent callers submit single requests; a collector thread coalesces
everything that arrives within a deadline window (or up to ``max_batch``)
into ONE batched evaluation. Under load the window fills and per-request
cost amortizes toward the batched throughput; an idle request pays at most
the window.

``_BatcherCore`` owns the engine-agnostic machinery (queue, deadline
window, future lifecycle, shutdown races); subclasses supply ``_execute``,
the batched evaluation, which runs on the collector thread (so a
``QueryEngine``'s device work happens there). Two front doors ride on it:

  * ``MicroBatcher`` — viewport queries against a ``QueryEngine``;
  * ``serve/layout_service.py:LayoutService`` — whole-graph layout
    requests, coalesced into ``multigila_layout_many`` batches.
"""
from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from repro_torch.serve.query import QueryEngine, trim_result


class _BatcherCore:
    """Deadline-window request coalescing (engine-agnostic core)."""

    def __init__(self, *, max_batch: int = 64, window_s: float = 0.002):
        self.max_batch = max_batch
        self.window_s = window_s
        self.batches = 0
        self.requests = 0
        self._q: queue.Queue = queue.Queue()
        self._closed = False
        # orders every put against close(): nothing can slip into the queue
        # after the shutdown sentinel, so no future is left unresolved
        self._lock = threading.Lock()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()

    # -- subclass contract ---------------------------------------------------
    def _execute(self, payloads: list) -> list:
        """Evaluate one batch; returns one result per payload, in order."""
        raise NotImplementedError

    def _submit_payload(self, payload) -> Future:
        """Enqueue one payload; resolves to ``_execute``'s per-item result."""
        fut: Future = Future()
        with self._lock:
            if self._closed:
                raise RuntimeError("batcher is closed")
            self._q.put((payload, fut))
        return fut

    # -- collector loop ------------------------------------------------------
    def _collect(self) -> list | None:
        """Block for the first request, then drain until deadline/max."""
        item = self._q.get()
        if item is None:
            return None
        batch = [item]
        deadline = time.monotonic() + self.window_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                self._q.put(None)   # re-arm shutdown for the outer loop
                break
            batch.append(nxt)
        return batch

    def _run(self):
        while True:
            batch = self._collect()
            if batch is None:
                break
            # claim each future; a caller may have cancelled while queued
            # (timeout wrappers) — completing a cancelled future would raise
            # InvalidStateError and kill this thread
            batch = [item for item in batch
                     if item[1].set_running_or_notify_cancel()]
            if not batch:
                continue
            self.batches += 1
            self.requests += len(batch)
            try:
                results = self._execute([p for p, _ in batch])
            except Exception as e:
                for _, fut in batch:
                    fut.set_exception(e)
                continue
            for (_, fut), res in zip(batch, results):
                fut.set_result(res)
        self._drain()

    def _drain(self):
        """Cancel whatever is still queued once nobody will serve it
        (requests racing close() must not block their callers forever)."""
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                return
            if item is not None:
                item[1].cancel()

    def close(self):
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._q.put(None)   # under the lock: nothing enqueues after it
        self._worker.join(timeout=30)
        self._drain()   # anything the worker left when the sentinel hit


class MicroBatcher(_BatcherCore):
    """Deadline-window viewport-query coalescing in front of a QueryEngine."""

    def __init__(self, engine: QueryEngine, *, max_batch: int = 64,
                 window_s: float = 0.002, trim: bool = True):
        self.engine = engine
        self.trim = trim
        super().__init__(max_batch=max_batch, window_s=window_s)

    def submit(self, box, zoom: int) -> Future:
        """Enqueue one viewport; resolves to the (trimmed) query result."""
        return self._submit_payload(
            (np.asarray(box, np.float32).reshape(4), int(zoom)))

    def _execute(self, payloads: list) -> list:
        boxes = np.stack([b for b, _ in payloads])
        zooms = np.asarray([z for _, z in payloads], np.int32)
        out = self.engine.query(boxes, zooms)
        if self.trim:
            return [trim_result(out, i) for i in range(len(payloads))]
        return [{k: v[i] for k, v in out.items()}
                for i in range(len(payloads))]
