"""The refinement-engine seam: per-level force models as pluggable steps.

The multilevel driver (coarsen → place → refine, core/multilevel.py) fixes
the hierarchy and treats the per-level refinement as a black box; a
``RefinementEngine`` supplies it, as in the JAX package's ``core/engine.py``:

  * ``init_state``    — per-level setup: the k-hop neighbor lists for
                        ``mode="neighbor"``, zero dummies otherwise;
  * ``lane_schedule`` — the scalars the step anneals each iteration, length
                        ``sched_k``: GiLA's (temp0, temp_decay), and
                        maxent-stress adds (alpha0, alpha_decay);
  * ``schedule_rows`` — those scalars unrolled on the host into float32
                        rows (temperature, C·L², md²), one an iteration;
  * ``prepare``       — the engine's position-independent per-level terms;
  * ``step``          — ONE iteration on tensors alone: every number it
                        reads (schedule row, params (C, L, min_dist)) lies
                        in device memory;
  * ``refine``        — the level's iterations as a Python loop of
                        ``step`` (the ``bucketing=False`` path);
  * ``build_refine``  — a ``RefineProgram``: the step over static buffers,
                        captured once as a CUDA graph on the card, which
                        ``core/bucketing.py`` caches per shape bucket, as the
                        JAX package caches its jitted builders;
  * ``tune``          — a hook over the freshly built ``LevelSchedule``.

Engines register themselves in ``ENGINES`` by name; ``get_engine`` imports
``core/stress.py`` on first use, so the GiLA-only path never loads it.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.core import gila
from repro_torch.graphs.graph import PaddedGraph
from repro_torch.utils.cuda_graph import StepGraph
from repro_torch.utils.device import synchronize


class RefinementEngine:
    """One per-level refinement force model (see module docstring)."""

    #: registry id; also the ``LevelSchedule.engine`` value
    name: str = "?"
    #: length of the ``lane_schedule`` tuple
    sched_k: int = 2

    def lane_schedule(self, sched) -> tuple:
        """The annealing scalars of one level, length ``sched_k``."""
        raise NotImplementedError

    def schedule_rows(self, sched, *, ideal_len: float, rep_const: float,
                      min_dist: float = 1e-3) -> np.ndarray:
        """float32[sched.iters, 3]: (temperature, C·L², md²) an iteration."""
        raise NotImplementedError

    def prepare(self, g: PaddedGraph, params) -> tuple:
        """Per-level terms of ``step`` (tensors) from the level and
        ``params`` = float32[3] (C, L, min_dist) on its device."""
        return ()

    def step(self, g: PaddedGraph, pos, nbr_idx, nbr_mask, terms, row,
             params, *, mode: str, grid_dim: int = 0, cell_cap: int = 0
             ) -> torch.Tensor:
        """One iteration from ``pos`` with schedule row ``row``."""
        raise NotImplementedError

    def tune(self, sched):
        """Hook over a freshly built ``LevelSchedule``; default: unchanged."""
        return sched

    def init_state(self, g: PaddedGraph, sched, seed: int
                   ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-level (nbr_idx, nbr_mask): the k-hop lists for neighbor mode
        (a host build, the same for every engine so forces are comparable
        on identical lists), zero dummies for the dense modes."""
        if sched.mode == "neighbor":
            return gila.build_level_neighbors(g, sched.k, sched.cap,
                                              seed=seed)
        return (torch.zeros((g.n_pad, 1), dtype=torch.int32, device=g.device),
                torch.zeros((g.n_pad, 1), dtype=torch.bool, device=g.device))

    def refine(self, g: PaddedGraph, pos0, nbr_idx, nbr_mask, sched, *,
               ideal_len: float, rep_const: float,
               min_dist: float = 1e-3) -> torch.Tensor:
        """``sched.iters`` iterations from ``pos0`` → positions [n_pad, 2],
        one ``step`` after another from Python."""
        dev = g.device
        rows = torch.from_numpy(self.schedule_rows(
            sched, ideal_len=ideal_len, rep_const=rep_const,
            min_dist=min_dist)).to(dev)
        params = torch.tensor([rep_const, ideal_len, min_dist],
                              dtype=torch.float32, device=dev)
        terms = self.prepare(g, params)
        pos = pos0.to(device=dev, dtype=torch.float32)
        for i in range(sched.iters):
            pos = self.step(g, pos, nbr_idx, nbr_mask, terms, rows[i],
                            params, mode=sched.mode, grid_dim=sched.grid_dim,
                            cell_cap=sched.cell_cap)
        return pos

    def build_refine(self, mode: str, grid_dim: int, cell_cap: int
                     ) -> "RefineProgram":
        """The level's refine program for one shape bucket (see
        ``RefineProgram``)."""
        return RefineProgram(self, mode, grid_dim, cell_cap)


class GilaEngine(RefinementEngine):
    """Fruchterman–Reingold with k-hop-restricted repulsion (paper §3.4);
    the per-iteration math lives in ``gila.layout_iteration``."""

    name = "gila"
    sched_k = 2                     # (temp0, temp_decay)

    def lane_schedule(self, sched) -> tuple:
        return (sched.temp0, sched.temp_decay)

    def schedule_rows(self, sched, *, ideal_len, rep_const, min_dist=1e-3):
        temp0, temp_decay = self.lane_schedule(sched)
        return gila.schedule_rows(
            gila.temperatures(temp0, temp_decay, sched.iters),
            [rep_const] * sched.iters, ideal_len, min_dist)

    def step(self, g, pos, nbr_idx, nbr_mask, terms, row, params, *, mode,
             grid_dim=0, cell_cap=0):
        return gila.layout_iteration(g, pos, nbr_idx, nbr_mask, row,
                                     params[1], mode=mode, grid_dim=grid_dim,
                                     cell_cap=cell_cap)


# -- the step program ----------------------------------------------------------

class RefineProgram:
    """One engine's refine ``step`` over static buffers: the counterpart of
    the JAX package's jitted per-bucket refine step.

    It owns a copy of every input of the step — the level's graph arrays
    (with ``n``/``m`` normalized to 0, which the step never reads), the
    positions, the neighbor lists, the params (C, L, min_dist), the
    engine's per-level terms, a schedule buffer of ``ROWS`` rows and an
    iteration counter that selects its row. ``run`` copies a level into
    them (the first call allocates them at the level's shapes; the cache
    key guarantees that every later level has the same ones) and steps
    ``iters`` times: the step reads row ``counter`` and advances the
    counter. A level with more than ``ROWS`` iterations refills the rows
    and resets the counter in chunks, so the iteration count stays out of
    the key. On the card the step is a ``StepGraph``: its first call runs
    eagerly and captures it, every later call (of any level, graph or
    temperature of the bucket) replays it. On the CPU it runs eagerly on
    the same buffers. One lock serialises ``run``: the buffers are shared.
    """

    #: rows of the schedule buffer
    ROWS = 128

    def __init__(self, engine: RefinementEngine, mode: str, grid_dim: int,
                 cell_cap: int):
        self.engine, self.mode = engine, mode
        self.grid_dim, self.cell_cap = grid_dim, cell_cap
        self._lock = threading.Lock()
        self._bufs = None
        #: seconds the last ``run`` spent on the warm-up step and capture
        #: (0.0 when the graph already existed, and always on the CPU)
        self.compile_seconds = 0.0

    def _allocate(self, g: PaddedGraph, nbr_idx, nbr_mask):
        dev = g.device
        fields = {f.name: torch.empty_like(getattr(g, f.name))
                  for f in dataclasses.fields(g) if f.name not in ("n", "m")}
        sg = PaddedGraph(**fields, n=0, m=0)
        sg.__dict__["src_l"] = torch.empty(g.m_pad, dtype=torch.int64,
                                           device=dev)
        sg.__dict__["dst_l"] = torch.empty(g.m_pad, dtype=torch.int64,
                                           device=dev)
        # the schedule rows and the params in one buffer: one copy a chunk
        host = torch.empty(self.ROWS * 3 + 3, dtype=torch.float32,
                           pin_memory=dev.type == "cuda")
        table = torch.empty_like(host, device=dev)
        self._bufs = dict(
            g=sg, pos=torch.empty((g.n_pad, 2), dtype=torch.float32,
                                  device=dev),
            nbr_idx=torch.empty_like(nbr_idx), nbr_mask=torch.empty_like(
                nbr_mask), host=host, table=table,
            rows=table[:self.ROWS * 3].view(self.ROWS, 3),
            params=table[self.ROWS * 3:],
            counter=torch.zeros(1, dtype=torch.int64, device=dev),
            terms=None, copied=None)
        self._step = StepGraph(self._iteration, dev)

    def _iteration(self) -> None:
        b = self._bufs
        row = b["rows"].index_select(0, b["counter"])[0]
        pos = self.engine.step(b["g"], b["pos"], b["nbr_idx"], b["nbr_mask"],
                               b["terms"], row, b["params"], mode=self.mode,
                               grid_dim=self.grid_dim,
                               cell_cap=self.cell_cap)
        b["pos"].copy_(pos)
        b["counter"].add_(1)

    def _load_rows(self, rows: np.ndarray, params: np.ndarray) -> None:
        """Stage rows (≤ ROWS) and params, and reset the counter. The pinned
        host buffer is reused only once its last copy has run."""
        b = self._bufs
        if b["copied"] is not None:
            b["copied"].synchronize()
        host = b["host"].numpy()
        host[:rows.size] = rows.reshape(-1)
        host[self.ROWS * 3:] = params
        b["table"].copy_(b["host"], non_blocking=True)
        if b["table"].device.type == "cuda":
            b["copied"] = torch.cuda.Event()
            b["copied"].record()
        b["counter"].zero_()

    def _stage(self, g: PaddedGraph, pos0, nbr_idx, nbr_mask) -> None:
        b = self._bufs
        sg = b["g"]
        for f in dataclasses.fields(g):
            if f.name not in ("n", "m"):
                getattr(sg, f.name).copy_(getattr(g, f.name))
        sg.src_l.copy_(sg.src)
        sg.dst_l.copy_(sg.dst)
        b["pos"].copy_(pos0)
        b["nbr_idx"].copy_(nbr_idx)
        b["nbr_mask"].copy_(nbr_mask)

    def run(self, g: PaddedGraph, pos0, nbr_idx, nbr_mask, rows: np.ndarray,
            params: np.ndarray) -> torch.Tensor:
        """``len(rows)`` iterations of the level ``g`` from ``pos0`` with
        schedule ``rows`` (float32[iters, 3]) and ``params`` (float32[3]:
        C, L, min_dist) → positions [n_pad, 2] (a tensor of its own)."""
        with self._lock:
            if self._bufs is None:
                self._allocate(g, nbr_idx, nbr_mask)
            b = self._bufs
            self._stage(g, pos0, nbr_idx, nbr_mask)
            self._load_rows(rows[:self.ROWS], params)
            terms = self.engine.prepare(b["g"], b["params"])
            if b["terms"] is None:
                b["terms"] = tuple(t.clone() for t in terms)
            else:
                for dst, src in zip(b["terms"], terms):
                    dst.copy_(src)
            self.compile_seconds = 0.0
            for c0 in range(0, len(rows), self.ROWS):
                if c0:
                    self._load_rows(rows[c0:c0 + self.ROWS], params)
                for _ in range(min(self.ROWS, len(rows) - c0)):
                    if self._step.captured or g.device.type != "cuda":
                        self._step()
                        continue
                    t0 = time.perf_counter()
                    self._step()
                    synchronize(g.device)
                    self.compile_seconds = time.perf_counter() - t0
            return b["pos"].clone()


# -- registry -----------------------------------------------------------------

ENGINES: dict[str, RefinementEngine] = {}


def register(eng: RefinementEngine) -> RefinementEngine:
    ENGINES[eng.name] = eng
    return eng


def get_engine(name: str) -> RefinementEngine:
    """Engine by registry id; 'stress' loads core/stress.py on first use."""
    if name not in ENGINES and name == "stress":
        import repro_torch.core.stress  # noqa: F401  — registers on import
    try:
        return ENGINES[name]
    except KeyError:
        raise ValueError(f"unknown refinement engine {name!r}; "
                         f"known: {sorted(ENGINES)}") from None


register(GilaEngine())
