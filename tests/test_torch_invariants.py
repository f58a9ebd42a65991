"""The JAX package's jaxpr-audit invariants, as checks of the port's cached
refine programs on the CPU.

gilalint's audit (``tools/gilalint/jaxpr_audit.py``) holds every jitted
step of the JAX package to four invariants. Three still apply to the port's
step programs (``core/engine.py:RefineProgram``, ``RefineManyProgram``,
``core/distributed.py:DistStep``), whose steps run from device tensors
alone and are captured as CUDA graphs on the card:

* A1, no host round-trip inside a step: ``Tensor.item``, ``tolist``,
  ``__bool__``, ``__int__``, ``__float__``, ``__index__``, ``numpy`` and
  ``cpu`` raise while a step runs (each is a device-to-host read on the
  card); ``chip_smoke.py`` phase 4g runs the same steps on the card under
  ``torch.cuda.set_sync_debug_mode("error")``;
* A2, no float64: no static buffer of a program and no output it returns
  is float64 (positions and forces are float32, indices int32 or int64);
* A4, padding invariance: two graphs with a different true n in one bucket
  (the same n_pad, m_pad and K) share one step-cache entry — the second is
  a hit on the first's — and each gives, bit for bit, the result of its own
  run on a cold cache, for the cache keys ``refine``, ``refine_many`` and
  ``dist_step`` (a one-rank gloo mesh).

A3 (donation) has no counterpart: the programs update their static
position buffers in place.
"""
import contextlib
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro_torch.core import bucketing
from repro_torch.core import distributed as D
from repro_torch.core.engine import RefineManyProgram, RefineProgram
from repro_torch.core.schedule import make_schedule
from repro_torch.graphs import generators as G
from repro_torch.graphs.graph import PaddedGraph, build_graph
from repro_torch.launch import mesh as mesh_mod

MODES = dict(exact=dict(exact_threshold=10 ** 6),
             neighbor=dict(exact_threshold=64, grid_threshold=10 ** 6),
             grid=dict(exact_threshold=64, grid_threshold=256))
ENGINES = ("gila", "stress")
# delaunay graphs of a different true n in one bucket: n_pad 1024,
# m_pad 4096, K 256 (k = 5 for 1000 ≤ m < 5000)
PAIR = ((600, 2), (540, 7))
HOST_READS = ("item", "tolist", "__bool__", "__int__", "__float__",
              "__index__", "numpy", "cpu")
KW = dict(ideal_len=1.3, rep_const=0.8, min_dist=2e-3)


@contextlib.contextmanager
def no_host_reads():
    """Every host read of a tensor's values raises inside the block."""
    def refuse(name):
        def read(*args, **kwargs):
            raise AssertionError(f"host read Tensor.{name} inside a step")
        return read
    saved = {name: getattr(torch.Tensor, name) for name in HOST_READS}
    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, refuse(name))
        yield
    finally:
        for name, fn in saved.items():
            setattr(torch.Tensor, name, fn)


def _guarded(fn):
    def step(*args, **kwargs):
        with no_host_reads():
            return fn(*args, **kwargs)
    return step


def _level(n, graph, mode, engine, seed=3, iters=12):
    edges, n = G.delaunay(n, seed=graph)
    g = build_graph(edges, n, bucket=True, device="cpu")
    sched = make_schedule(0, 3, g.n, g.m, n_pad=g.n_pad, engine=engine,
                          **MODES[mode])
    assert sched.mode == mode
    rng = np.random.default_rng(seed)
    pos0 = torch.from_numpy((rng.random((g.n_pad, 2)) * 20).astype(
        np.float32))
    return g, pos0, dataclasses.replace(sched, iters=iters, temp0=0.7)


def _refine(n, graph, mode, engine, **kw):
    g, pos0, sched = _level(n, graph, mode, engine, **kw)
    return bucketing.refine_level(g, pos0, sched, seed=graph, **KW)


def _refine_many(lanes, mode, engine):
    reqs = []
    for n, graph in lanes:
        g, pos0, sched = _level(n, graph, mode, engine)
        reqs.append(bucketing.make_request(g, pos0, sched, graph))
    return bucketing.refine_level_many(reqs, lanes_min=2, **KW)


def _tensors(x):
    """Every tensor in a program's buffers (dicts, tuples, graphs)."""
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, PaddedGraph):
        for f in dataclasses.fields(x):
            yield from _tensors(getattr(x, f.name))
        yield from _tensors(x.__dict__.get("src_l"))
        yield from _tensors(x.__dict__.get("dst_l"))
    elif isinstance(x, dict):
        for v in x.values():
            yield from _tensors(v)
    elif isinstance(x, (tuple, list)):
        for v in x:
            yield from _tensors(v)


def _assert_32_bits(label, bufs, *outs):
    ts = list(_tensors(bufs)) + list(_tensors(outs))
    assert ts, label
    wide = {t.dtype for t in ts if t.dtype in (torch.float64,
                                                torch.complex128)}
    assert not wide, (label, wide)
    assert all(t.dtype == torch.float32 for t in _tensors(outs)), label


def _entries(kind):
    return [(k, p) for k, p in bucketing.STEP_CACHE.entries.items()
            if k[0] == kind]


# -- A1 and A2: the single-graph and batched programs ---------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ENGINES)
def test_refine_step_reads_nothing_to_the_host(mode, engine, monkeypatch):
    """Every iteration of a cached ``RefineProgram`` (cold, then warm with
    the schedule refilled in chunks) runs with the host reads refused, and
    its buffers and output hold no float64."""
    monkeypatch.setattr(RefineProgram, "_iteration",
                        _guarded(RefineProgram._iteration))
    monkeypatch.setattr(RefineProgram, "ROWS", 8)
    bucketing.STEP_CACHE.clear()
    cold = _refine(600, 2, mode, engine)
    warm = _refine(540, 7, mode, engine, iters=19)
    [(key, prog)] = _entries("refine")
    assert bucketing.cache_stats()["hits"] == 1
    _assert_32_bits(key, prog._bufs, cold, warm)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ENGINES)
def test_refine_many_step_reads_nothing_to_the_host(mode, engine,
                                                    monkeypatch):
    """The same for the batched ``RefineManyProgram``: two lanes, then a
    warm group with other graphs."""
    monkeypatch.setattr(RefineManyProgram, "_iteration",
                        _guarded(RefineManyProgram._iteration))
    bucketing.STEP_CACHE.clear()
    cold = _refine_many(PAIR, mode, engine)
    warm = _refine_many(PAIR[::-1], mode, engine)
    [(key, prog)] = _entries("refine_many")
    assert bucketing.cache_stats()["hits"] == 1
    _assert_32_bits(key, prog._bufs, cold, warm)


def test_host_reads_are_refused_inside_the_guard():
    """The guard itself: each read raises inside, and works again after."""
    t = torch.ones(3)
    with no_host_reads():
        for name in HOST_READS:
            with pytest.raises(AssertionError, match=name):
                getattr(t, name)()
        with pytest.raises(AssertionError, match="__bool__"):
            bool(t[0])
    assert t.sum().item() == 3.0 and bool(t[0]) and t.tolist() == [1.0] * 3


# -- A4: padding invariance -------------------------------------------------------

def _pair_shapes(mode, engine):
    (g1, _, s1), (g2, _, s2) = (_level(n, graph, mode, engine)
                                for n, graph in PAIR)
    assert g1.n != g2.n
    assert (g1.n_pad, g1.m_pad, s1.cap) == (g2.n_pad, g2.m_pad, s2.cap)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ENGINES)
def test_refine_entry_is_padding_invariant(mode, engine):
    _pair_shapes(mode, engine)
    bucketing.STEP_CACHE.clear()
    first = _refine(*PAIR[0], mode, engine)
    second = _refine(*PAIR[1], mode, engine)
    assert bucketing.cache_stats() == dict(entries=1, hits=1, misses=1)
    for (n, graph), warm in ((PAIR[0], first), (PAIR[1], second)):
        bucketing.STEP_CACHE.clear()
        assert torch.equal(_refine(n, graph, mode, engine), warm)
        assert bucketing.cache_stats()["hits"] == 0


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ENGINES)
def test_refine_many_entry_is_padding_invariant(mode, engine):
    bucketing.STEP_CACHE.clear()
    first = _refine_many(PAIR[:1], mode, engine)
    second = _refine_many(PAIR[1:], mode, engine)
    assert bucketing.cache_stats() == dict(entries=1, hits=1, misses=1)
    for lane, warm in ((PAIR[:1], first), (PAIR[1:], second)):
        bucketing.STEP_CACHE.clear()
        cold = _refine_many(lane, mode, engine)
        assert bucketing.cache_stats()["hits"] == 0
        assert torch.equal(cold[0], warm[0])


@pytest.fixture(scope="module")
def mesh():
    """A one-rank gloo mesh for the module, taken down after it."""
    import torch.distributed as dist
    assert not dist.is_initialized()
    m = mesh_mod.make_host_mesh(device="cpu")
    yield m
    mesh_mod.shutdown()


def _dist(mesh, n, graph, mode, engine):
    g, pos0, sched = _level(n, graph, mode, engine)
    return D.run_layout_level(mesh, g, pos0, sched, seed=graph, **KW)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ENGINES)
def test_dist_step_entry_is_padding_invariant(mesh, mode, engine,
                                              monkeypatch):
    """The sharded step on a one-rank gloo mesh: one entry for the pair, a
    hit for the second graph, each graph's cold bits; every iteration runs
    with the host reads refused, and the entry's buffers, the staged
    schedule and the output hold no float64."""
    monkeypatch.setattr(D.DistStep, "__call__",
                        _guarded(D.DistStep.__call__))
    bucketing.STEP_CACHE.clear()
    first = _dist(mesh, *PAIR[0], mode, engine)
    second = _dist(mesh, *PAIR[1], mode, engine)
    assert bucketing.cache_stats() == dict(entries=1, hits=1, misses=1)
    [(key, step)] = _entries("dist_step")
    g, pos0, sched = _level(*PAIR[1], mode, engine)
    run = D.prepare_level(mesh, g, pos0, sched, seed=PAIR[1][1], **KW)
    _assert_32_bits(key, step.buf, first, second)
    _assert_32_bits(key, [run.temps, run.alphas, run.pos])
    for (n, graph), warm in ((PAIR[0], first), (PAIR[1], second)):
        bucketing.STEP_CACHE.clear()
        assert torch.equal(_dist(mesh, n, graph, mode, engine), warm)
        assert bucketing.cache_stats()["hits"] == 0
