"""Shape buckets and the process-wide cache of refine step programs.

The JAX package's ``core/bucketing.py`` on torch. Every level of the
bucketed multilevel driver is padded to pow2 shape buckets
(``graphs.graph.bucket_pad``), so all levels of all hierarchies share
O(log n) shapes, and each level's refinement runs through one cached step
program per key

    ("refine", engine, n_pad, m_pad, K, mode, grid_dim, cell_cap, device)

— the JAX key with the device in the kernel backend's place. The program
(``engine.RefineProgram``) holds the step of ONE iteration over static
buffers; on the card it is a captured CUDA graph, replayed once per
iteration. The iteration count, the schedule rows (temperature, C·L², md²)
and the params (C, L, min_dist) are device data, not part of the key, so one
entry serves every level, graph, seed and constant whose arrays land in its
bucket, and a fresh graph whose levels land in warm buckets captures
nothing new. On the CPU the same program runs its step eagerly on the same
buffers, so keys, hits and misses behave alike on both devices.

``refine_level`` books a cold entry's warm-up iteration plus its capture
under the ``compile`` phase and everything else (the k-hop build, staging,
replays) under ``refine``. ``LayoutConfig(bucketing=False)`` bypasses this
module: exact-shape padding and the engine's eager ``refine`` loop.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from repro_torch.core.engine import get_engine
from repro_torch.graphs.graph import PaddedGraph
from repro_torch.utils.device import synchronize


class CompileCache:
    """Process-wide cache of step programs keyed on shape buckets.

    ``get(key, builder)`` returns ``(program, fresh)``; ``fresh=True`` means
    the builder ran (the program's first run warms up and captures).
    Lock-protected: callers in several threads share one instance."""

    def __init__(self):
        self.entries: dict = {}
        self.hits = 0
        self.misses = 0
        self._lock = threading.RLock()

    def get(self, key, builder):
        with self._lock:
            prog = self.entries.get(key)
            if prog is not None:
                self.hits += 1
                return prog, False
            self.misses += 1
            prog = builder()
            self.entries[key] = prog
            return prog, True

    def clear(self) -> None:
        """Drop every entry (and with it its buffers and CUDA graph)."""
        with self._lock:
            self.entries.clear()
            self.hits = 0
            self.misses = 0


STEP_CACHE = CompileCache()


def cache_stats() -> dict:
    """entries/hits/misses of the step cache. The JAX package also reports
    ``jit_entries``, the trace-cache sizes of its jitted functions; PyTorch
    runs eagerly outside this cache, so the port has no counterpart."""
    return dict(entries=len(STEP_CACHE.entries), hits=STEP_CACHE.hits,
                misses=STEP_CACHE.misses)


def cached_refine(g: PaddedGraph, pos0, sched, nbr_idx, nbr_mask, *,
                  ideal_len: float, rep_const: float, min_dist: float = 1e-3):
    """(cache_key, program, fresh, args) for one level's bucketed refine:
    the single place where the key is derived and the program's arguments
    staged. ``sched.engine`` picks the step AND is part of the key, so gila
    and stress entries of one bucket never collide."""
    eng = get_engine(sched.engine)
    key = ("refine", sched.engine, g.n_pad, g.m_pad, int(nbr_idx.shape[1]),
           sched.mode, sched.grid_dim, sched.cell_cap, str(g.device))
    prog, fresh = STEP_CACHE.get(
        key, lambda: eng.build_refine(sched.mode, sched.grid_dim,
                                      sched.cell_cap))
    rows = eng.schedule_rows(sched, ideal_len=ideal_len, rep_const=rep_const,
                             min_dist=min_dist)
    params = np.asarray([rep_const, ideal_len, min_dist], np.float32)
    args = (g, pos0.to(device=g.device, dtype=torch.float32), nbr_idx,
            nbr_mask, rows, params)
    return key, prog, fresh, args


def refine_level(g: PaddedGraph, pos0, sched, *, ideal_len: float,
                 rep_const: float, min_dist: float = 1e-3, seed: int = 0,
                 phases: dict | None = None) -> torch.Tensor:
    """Refine one level for ``sched.iters`` iterations from ``pos0`` through
    the cached step program of its bucket. With ``phases`` (a
    ``LayoutStats.phase_seconds``), the warm-up and capture of a cold entry
    are added to ``phases["compile"]`` and the rest of the call, ended by a
    device synchronize, to ``phases["refine"]``."""
    t0 = time.perf_counter()
    eng = get_engine(sched.engine)
    nbr_idx, nbr_mask = eng.init_state(g, sched, seed)
    _, prog, _, args = cached_refine(g, pos0, sched, nbr_idx, nbr_mask,
                                     ideal_len=ideal_len,
                                     rep_const=rep_const, min_dist=min_dist)
    pos = prog.run(*args)
    if phases is not None:
        synchronize(g.device)
        phases["compile"] += prog.compile_seconds
        phases["refine"] += time.perf_counter() - t0 - prog.compile_seconds
    return pos
