"""One step of work captured as a CUDA graph on the card and replayed.

A CUDA graph is to a CUDA stream what an XLA executable is to a jitted
function: the launches of one call, recorded once and replayed with no
Python in between. ``StepGraph`` wraps a step ``fn()`` that reads and writes
only tensors that outlive it (static buffers whose addresses the graph
records), so every value that changes between calls must already lie in
device memory.

On the card the first call runs ``fn`` eagerly on a side stream (a real
step, which also builds whatever the step's callees build on first use:
the kernel library, cached tables, per-stream scratch) and then captures
one more call of ``fn`` on that stream; every later call replays the graph.
On the CPU every call runs ``fn`` eagerly, so the same object with the same
buffers behaves alike on both devices.

The kernel wrappers count their launches in ``kernels._build.launches``,
a Python counter: during the capture nothing runs, so the launches that
the capturing thread counts go to a record of the capture
(``_build.capturing``) that is added once per replay instead.

Threads: a serving process does device work on several threads at once
(the layout engine's worker, the viewport batcher's). A capture is taken in
CUDA's thread-local capture mode, so another thread's CUDA calls during it
(allocations, synchronizes, launches on its own stream) neither fail nor
spoil the capture, and ``CAPTURE_LOCK`` lets one warm-up and capture run
at a time in the process (``torch.cuda.graph`` synchronizes the device and
empties the allocator's cache on entry, which must not fall inside another
thread's capture).
"""
from __future__ import annotations

import collections
import threading

import torch

from repro_torch.kernels import _build

#: held for the length of every warm-up and capture in the process
CAPTURE_LOCK = threading.Lock()


class StepGraph:
    """``fn`` run once per call: eagerly on the CPU, by graph replay on the
    card (see the module docstring)."""

    def __init__(self, fn, device: torch.device):
        self.fn = fn
        self.device = torch.device(device)
        self.graph: torch.cuda.CUDAGraph | None = None
        #: kernel launches of one replay: (by kernel, by shape)
        self.launches = (collections.Counter(), collections.Counter())

    @property
    def captured(self) -> bool:
        return self.graph is not None

    def __call__(self) -> None:
        if self.device.type != "cuda":
            self.fn()
        elif self.graph is None:
            self._warm_up_and_capture()
        else:
            self.graph.replay()
            _build.replayed(self.launches)

    def _warm_up_and_capture(self) -> None:
        main = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        graph = torch.cuda.CUDAGraph()
        with CAPTURE_LOCK:
            side.wait_stream(main)        # the inputs staged on ``main``
            with torch.cuda.stream(side):
                self.fn()                 # this call's step, run eagerly
            with _build.capturing() as made, torch.cuda.graph(
                    graph, stream=side, capture_error_mode="thread_local"):
                self.fn()
            main.wait_stream(side)
        self.graph, self.launches = graph, made
