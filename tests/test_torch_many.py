"""The port's batched multi-graph driver (``multigila_layout_many``, the wave
scheduler, packing, the lane axis of the force kernels) against the port's
sequential driver and the live JAX package on the CPU.

Tolerances:

* batched against the port's sequential driver: bit for bit — the JAX
  package's own contract (``tests/test_many.py``). On the CPU every lane
  runs the arithmetic of the single-graph step in the same order: the
  kernels' plain versions take one lane at a time, re-padding adds only
  zeros, and the incidence-gather edge sums add each vertex's messages in
  ``index_add_``'s ascending slot order;
* batched against JAX's ``multigila_layout_many``: level sizes equal, NELD
  within 0.05 and CRE within 0.15 (``test_torch_layout.py``);
* integer tables (re-padded graphs, incidence tables, bins, group keys,
  lane buckets): equal to JAX's;
* the kernels' plain versions over lanes against ``jax.vmap`` of the JAX
  references: ``test_torch_kernels.py``'s rtol 1e-5, atol 1e-5 · max|f|
  (only the order of the sums over sources differs).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

from repro.core import bucketing as jax_bucketing
from repro.core import multigila_layout_many as jax_many
from repro.core.multilevel import LayoutConfig as JaxConfig
from repro.core.multilevel import build_hierarchy as jax_build_hierarchy
from repro.core.schedule import make_schedule as jax_make_schedule
from repro.graphs import generators as G
from repro.graphs import packing as jax_packing
from repro.graphs.graph import bucket_pad as jax_bucket_pad
from repro.graphs.graph import build_graph as jax_build_graph
from repro.graphs.metrics import quality_report as jax_quality
from repro.kernels.grid_force import ops as jax_grid
from repro.kernels.grid_force.ref import grid_far_ref as jax_far_ref
from repro.kernels.grid_force.ref import grid_near_ref as jax_near_ref
from repro.kernels.nbody.ref import nbody_repulsion_ref as jax_nbody_ref
from repro.kernels.neighbor_force.ref import \
    neighbor_repulsion_ref as jax_neighbor_ref
from repro_torch.core import (GraphJob, LayoutConfig, WaveScheduler,
                              bucketing, build_hierarchy, multigila_layout,
                              multigila_layout_many)
from repro_torch.core.engine import RefineManyProgram
from repro_torch.core.gila import lane_index, lane_segment_sum
from repro_torch.core.schedule import make_schedule
from repro_torch.graphs import packing
from repro_torch.graphs.graph import bucket_pad, build_graph, segment_sum
from repro_torch.graphs.metrics import quality_report
from repro_torch.kernels import _build
from repro_torch.kernels.grid_force import ops as grid_ops
from repro_torch.kernels.nbody.ops import nbody_repulsion
from repro_torch.kernels.neighbor_force.ops import neighbor_repulsion

NELD_DELTA, CRE_DELTA = 0.05, 0.15
RTOL = 1e-5
CPU = torch.device("cpu")
L_, MD = 0.8, 1e-2
LANE_C = (1.3, 0.4, 2.1)              # each lane's own C


# -- batched against sequential, bit for bit --------------------------------------

def _sequential(edges, n, cfg, weights=None):
    return multigila_layout(edges, n, cfg, weights=weights, device="cpu")


def _assert_parity(graphs, cfg, *, seeds=None, engines=None, weights=None):
    """Every graph of the batch bit-equal to its sequential layout; returns
    the group keys the batch dispatched."""
    keys = []
    real = bucketing.refine_level_many

    def spy(reqs, **kw):
        keys.append(bucketing.group_key(reqs[0]))
        return real(reqs, **kw)

    bucketing.refine_level_many = spy
    try:
        outs = multigila_layout_many(graphs, cfg, seeds=seeds,
                                     engines=engines, weights=weights,
                                     device="cpu")
    finally:
        bucketing.refine_level_many = real
    assert len(outs) == len(graphs)
    for i, (e, n) in enumerate(graphs):
        c = cfg if seeds is None else dataclasses.replace(cfg, seed=seeds[i])
        if engines is not None:
            c = dataclasses.replace(c, engine=engines[i])
        ps, ss = _sequential(e, n, c, None if weights is None else weights[i])
        pb, sb = outs[i]
        assert (sb.levels, sb.level_sizes, sb.level_modes) == (
            ss.levels, ss.level_sizes, ss.level_modes), i
        assert pb.shape == (n, 2)
        assert np.array_equal(pb, ps), f"graph {i}"
    return keys


def _weights(edges, seed):
    return np.random.default_rng(seed).uniform(0.5, 2.0, len(edges)).astype(
        np.float32)


def _disconnected():
    e1, n1 = G.delaunay(90, 1)
    e2, n2 = G.delaunay(70, 2)
    return np.concatenate([e1, e2 + n1]), n1 + n2


PARITY = {
    "b1": lambda: ([G.delaunay(150, 4)], LayoutConfig(seed=7), {}),
    "homogeneous": lambda: ([G.delaunay(150, 10 + i) for i in range(4)],
                            LayoutConfig(seed=5), {}),
    "mixed_buckets": lambda: ([G.delaunay(120, 3), G.delaunay(500, 4),
                               G.grid(14, 14), G.scale_free(200, 2, 5)],
                              LayoutConfig(seed=2), {}),
    "disconnected_seeds": lambda: ([_disconnected(), G.delaunay(150, 3)],
                                   LayoutConfig(seed=1),
                                   dict(seeds=[11, 12])),
    "neighbor_mode": lambda: ([G.delaunay(150, 20 + i) for i in range(2)],
                              LayoutConfig(seed=4, exact_threshold=64), {}),
    "grid_mode": lambda: ([G.delaunay(150, 20 + i) for i in range(2)],
                          LayoutConfig(seed=4, exact_threshold=64,
                                       grid_threshold=96), {}),
    "stress_weighted": lambda: (           # levels in all three modes
        [G.delaunay(300, 30), G.delaunay(150, 31), G.delaunay(150, 32)],
        LayoutConfig(seed=3, engine="stress", exact_threshold=64,
                     grid_threshold=200),
        dict(weights=[_weights(G.delaunay(*a)[0], i) for i, a in
                      enumerate(((300, 30), (150, 31), (150, 32)))])),
    "mixed_engines": lambda: ([G.delaunay(150, 30 + i) for i in range(3)],
                              LayoutConfig(seed=3),
                              dict(engines=["stress", "gila", "stress"])),
    "hub_lane": lambda: ([G.scale_free(300, 2, 9), G.delaunay(200, 3)],
                         LayoutConfig(seed=1), {}),
}


@pytest.mark.parametrize("case", sorted(PARITY))
def test_batched_equals_sequential_bit_for_bit(case):
    graphs, cfg, kw = PARITY[case]()
    keys = _assert_parity(graphs, cfg, **kw)
    modes, engines = {k[5] for k in keys}, {k[0] for k in keys}
    if case == "mixed_buckets":               # the inputs span lane buckets
        assert len({bucketing.lane_shape(n, len(e)) for e, n in graphs}) >= 2
    elif case == "neighbor_mode":
        assert "neighbor" in modes
    elif case == "grid_mode":
        assert "grid" in modes
    elif case == "stress_weighted":
        assert modes == {"grid", "neighbor", "exact"}, modes
    elif case == "hub_lane":
        assert any(k[4] == 0 for k in keys)           # flat-scatter lanes
        assert any(k[4] == bucketing.INC_K_MAX for k in keys)
    assert engines == ({"gila", "stress"} if case == "mixed_engines" else
                       {cfg.engine})


def test_batched_matches_jax():
    graphs = [G.delaunay(300, 41), G.delaunay(300, 42)]
    cfg = dict(seed=6)
    outs = multigila_layout_many(graphs, LayoutConfig(**cfg), device="cpu")
    ref = jax_many(graphs, JaxConfig(**cfg))
    for (e, n), (pt, st), (pj, sj) in zip(graphs, outs, ref):
        assert st.level_sizes == sj.level_sizes
        gj = jax_build_graph(e, n)
        qj = jax_quality(gj, np.asarray(pj))
        qt = quality_report(build_graph(e, n, device="cpu"), pt)
        assert abs(qt["neld"] - qj["neld"]) <= NELD_DELTA, (qt, qj)
        assert abs(qt["cre"] - qj["cre"]) <= CRE_DELTA, (qt, qj)


# -- packing against JAX -----------------------------------------------------------

GRAPH_FIELDS = ("src", "dst", "vmask", "emask", "mass", "ewt")


def test_bucket_pad_matches_jax():
    for minimum in (1, 64, 256, 512):
        for x in list(range(0, 600)) + [1023, 1024, 1025, 4097, 65536]:
            assert bucket_pad(x, minimum) == jax_bucket_pad(x, minimum)
    assert bucket_pad(100) == jax_bucket_pad(100) == 256


def _both(e, n, **kw):
    return (build_graph(e, n, bucket=True, device="cpu", **kw),
            jax_build_graph(e, n, bucket=True, **kw))


def _same_graph(gt, gj):
    assert (gt.n, gt.m, gt.n_pad, gt.m_pad) == (gj.n, gj.m, gj.n_pad,
                                                gj.m_pad)
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(gt, f).numpy(),
                                      np.asarray(getattr(gj, f)), f)


def test_repad_graph_matches_jax():
    e, n = G.delaunay(60, 3)
    w = _weights(e, 2)
    gt, gj = _both(e, n, ewt=w)
    for shape in ((64, 512), (128, 1024)):
        t2, j2 = packing.repad_graph(gt, *shape), jax_packing.repad_graph(
            gj, *shape)
        _same_graph(t2, j2)
        assert int(t2.src[~t2.emask].min()) == shape[0]      # new sentinel
        _same_graph(packing.repad_graph(t2, gt.n_pad, gt.m_pad), gj)
    with pytest.raises(ValueError):
        packing.repad_graph(gt, 32, 512)
    rows = torch.arange(10.0).reshape(5, 2)
    np.testing.assert_array_equal(packing.repad_rows(rows, 8).numpy(),
                                  np.asarray(jax_packing.repad_rows(
                                      rows.numpy(), 8)))
    assert torch.equal(packing.repad_rows(rows, 3), rows[:3])


def test_incidence_table_and_gather_match_segment_sum():
    e, n = G.delaunay(80, 5)
    gt, gj = _both(e, n)
    inc, k = packing.incidence_table(gt, 32)
    inc_j, k_j = jax_packing.incidence_table(gj, 32)
    assert k == k_j == 32
    np.testing.assert_array_equal(inc.numpy(), np.asarray(inc_j))
    # the gather over lanes sums in index_add_'s order, bit for bit
    rng = np.random.default_rng(0)
    pk = packing.pack_graphs([gt, gt], lanes=2)
    vec = torch.from_numpy(rng.standard_normal((2, gt.m_pad, 2)).astype(
        np.float32))
    vec = torch.where(pk.g.emask[..., None], vec, 0.0)
    _, _, flat_dst, flat_inc = lane_index(pk.g, torch.stack([inc, inc]))
    acc = lane_segment_sum(vec, flat_inc, flat_dst, gt.n_pad)
    flat = lane_segment_sum(vec, flat_inc[..., :0], flat_dst, gt.n_pad)
    for b in range(2):
        seg = segment_sum(vec[b], gt.dst_l, gt.n_pad + 1)[:gt.n_pad]
        assert torch.equal(acc[b], seg) and torch.equal(flat[b], seg)
    star = np.stack([np.zeros(40, np.int64), np.arange(1, 41)], axis=1)
    st, sj = _both(star, 41)
    assert packing.incidence_table(st, 32) == (None, 40)
    assert jax_packing.incidence_table(sj, 32) == (None, 40)


def test_lane_shapes_buckets_and_group_keys_match_jax():
    for b in range(1, 70):
        assert packing.lane_bucket(b) == jax_packing.lane_bucket(b)
        assert packing.lane_bucket(b, 2) == jax_packing.lane_bucket(b, 2)
    cfg, cfg_j = LayoutConfig(exact_threshold=300, grid_threshold=900), \
        JaxConfig(exact_threshold=300, grid_threshold=900)
    for e, n in (G.grid(6, 6), G.delaunay(1200, 2),
                 G.scale_free(300, 2, 9)):
        gt, gj = _both(e, n)
        graphs_t, _ = build_hierarchy(gt, cfg, device="cpu")
        graphs_j, _ = jax_build_hierarchy(gj, cfg_j)
        L = len(graphs_t)
        assert L == len(graphs_j)
        for i, (a, b) in enumerate(zip(graphs_t, graphs_j)):
            kw = dict(n_pad=a.n_pad, exact_threshold=300, grid_threshold=900)
            st = make_schedule(i, L, a.n, a.m, **kw)
            sj = jax_make_schedule(i, L, b.n, b.m, **kw)
            assert bucketing.lane_shape(a.n, a.m) == \
                jax_bucketing.lane_shape(b.n, b.m)
            rt = bucketing.make_request(a, torch.zeros((a.n_pad, 2)), st, 0)
            rj = jax_bucketing.make_request(b, jnp.zeros((b.n_pad, 2)), sj, 0)
            assert bucketing.group_key(rt) == jax_bucketing.group_key(rj)
            assert rt.inc_k == rj.inc_k
            np.testing.assert_array_equal(rt.inc.numpy(), np.asarray(rj.inc))
            _same_graph(rt.g, rj.g)


# -- the kernels' plain versions over lanes ----------------------------------------

def _lanes(n, B, seed):
    rng = np.random.default_rng(seed)
    pos = (rng.random((B, n, 2)) * 10).astype(np.float32)
    mass = (rng.random((B, n)) + 0.5).astype(np.float32)
    vmask = rng.random((B, n)) > 0.15
    return pos, mass, vmask


def _consts():
    return torch.tensor([_build.force_consts(c, L_, MD) for c in LANE_C],
                        dtype=torch.float32)


def _close(port, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(port, ref, rtol=RTOL,
                               atol=1e-5 * float(np.abs(ref).max()))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_nbody_and_neighbor_lanes_equal_single_calls_and_jax_vmap():
    B, n, K = len(LANE_C), 200, 24
    pos, mass, vmask = _lanes(n, B, 1)
    consts = _consts()
    rng = np.random.default_rng(2)
    nbr = rng.integers(0, n, (B, n, K))
    nmask = rng.random((B, n, K)) > 0.3
    nbr = np.where(nmask, nbr, n).astype(np.int32)
    cs = jnp.asarray(LANE_C, jnp.float32)
    cases = (
        (lambda *a: nbody_repulsion(*a, consts), (pos, mass, vmask),
         jax.vmap(jax_nbody_ref, in_axes=(0, 0, 0, 0, None, None))(
             pos, mass, vmask, cs, L_, MD)),
        (lambda *a: neighbor_repulsion(*a, consts),
         (pos, mass, nbr, nmask, vmask),
         jax.vmap(jax_neighbor_ref, in_axes=(0, 0, 0, 0, 0, 0, None, None))(
             pos, mass, nbr, nmask, vmask, cs, L_, MD)))
    for f, args, ref in cases:
        lanes = f(*map(_t, args))
        for b in range(B):
            single = (nbody_repulsion if len(args) == 3 else
                      neighbor_repulsion)(*(_t(a[b]) for a in args),
                                          consts[b])
            assert torch.equal(lanes[b], single)
        _close(lanes.numpy(), ref)


def test_grid_lanes_equal_single_calls_and_jax_vmap():
    B, n, G_, cap = len(LANE_C), 500, 6, 16
    pos, mass, vmask = _lanes(n, B, 3)
    pos[1] = pos[1] * 3.0 + 7.0                   # another box per lane
    consts = _consts()
    P, M, V = _t(pos), _t(mass), _t(vmask)
    cid, bucket, inb = grid_ops.bin_vertices(P, V, G_, cap)
    cid_j, bucket_j, inb_j = jax.vmap(
        lambda p, v: jax_grid.bin_vertices(p, v, G_, cap))(pos, vmask)
    np.testing.assert_array_equal(cid.numpy(), np.asarray(cid_j))
    np.testing.assert_array_equal(bucket.numpy(), np.asarray(bucket_j))
    np.testing.assert_array_equal(inb.numpy(), np.asarray(inb_j))
    table = grid_ops.neighbor_table(G_, CPU)
    near = grid_ops.grid_near(P, M, V, bucket, table, consts)
    cells = _t(np.concatenate([pos[:, :37], mass[:, :37, None]], axis=2))
    far = grid_ops.grid_far(P, cells, consts)
    rep = grid_ops.grid_repulsion(P, M, V, consts, grid_dim=G_, cell_cap=cap)
    for b in range(B):
        assert torch.equal(near[b], grid_ops.grid_near(
            P[b], M[b], V[b], bucket[b], table, consts[b]))
        assert torch.equal(far[b], grid_ops.grid_far(P[b], cells[b],
                                                     consts[b]))
        assert torch.equal(rep[b], grid_ops.grid_repulsion(
            P[b], M[b], V[b], consts[b], grid_dim=G_, cell_cap=cap))
    cs = jnp.asarray(LANE_C, jnp.float32)
    _close(far.numpy(), jax.vmap(jax_far_ref, in_axes=(0, 0, 0, None, None))(
        pos, cells.numpy(), cs, L_, MD))
    # the JAX package's pre-gather around its near kernel, lane by lane
    nc, b = G_ * G_, bucket.numpy()
    w = np.where(vmask, mass, 0).astype(np.float32)
    pos_p = np.concatenate([pos, np.zeros((B, 1, 2), np.float32)], axis=1)
    w_p = np.concatenate([w, np.zeros((B, 1), np.float32)], axis=1)
    nbr = b[:, table.numpy()[:nc]].reshape(B, nc, 9 * cap)
    lane = np.arange(B)[:, None, None]
    near_j = np.asarray(jax.vmap(jax_near_ref,
                                 in_axes=(0, 0, 0, 0, None, None))(
        pos_p[lane, b[:, :nc]], pos_p[lane, nbr], w_p[lane, nbr], cs, L_,
        MD))
    for k in range(B):
        f = np.zeros((n + 1, 2), np.float32)
        f[b[k, :nc].reshape(-1)] = near_j[k].reshape(-1, 2)
        _close(near[k].numpy(), f[:n])


# -- the warm path -------------------------------------------------------------

def test_fresh_same_bucket_batch_adds_no_miss():
    cfg = LayoutConfig(seed=6)
    multigila_layout_many([G.delaunay(150, 70 + i) for i in range(3)], cfg,
                          device="cpu")
    before = bucketing.cache_stats()
    outs = multigila_layout_many([G.delaunay(150, 80 + i) for i in range(3)],
                                 cfg, device="cpu")
    after = bucketing.cache_stats()
    assert all(o[1].levels >= 2 for o in outs)
    assert after["misses"] == before["misses"], (before, after)
    assert after["entries"] == before["entries"]
    assert after["hits"] > before["hits"]
    assert any(k[0] == "refine_many" for k in bucketing.STEP_CACHE.entries)


MODES = dict(exact=dict(exact_threshold=10 ** 6),
             neighbor=dict(exact_threshold=64, grid_threshold=10 ** 6),
             grid=dict(exact_threshold=64, grid_threshold=256))


def _requests(mode, engine, lanes):
    """One request a lane, (graph seed, pos seed, iterations) each: levels
    of delaunay(300) graphs, which share one lane bucket."""
    reqs = []
    for graph, seed, iters in lanes:
        e, n = G.delaunay(300, seed=graph)
        g = build_graph(e, n, bucket=True, device="cpu")
        sched = make_schedule(0, 3, g.n, g.m, n_pad=g.n_pad, engine=engine,
                              **MODES[mode])
        assert sched.mode == mode
        sched = dataclasses.replace(sched, iters=iters, temp0=0.7)
        rng = np.random.default_rng(seed)
        pos0 = torch.from_numpy((rng.random((g.n_pad, 2)) * 18).astype(
            np.float32))
        reqs.append(bucketing.make_request(g, pos0, sched, seed))
    assert len({bucketing.group_key(r) for r in reqs}) == 1
    return reqs


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("engine", ["gila", "stress"])
def test_warm_batched_entry_bakes_in_no_value(mode, engine, monkeypatch):
    """One batched entry, warmed by one group, then reused by another of
    the same key — other graphs, per-lane iteration counts (more than ROWS,
    so the schedule refills in chunks and the live test must use the
    global iteration), seeds, ideal_len and rep_const — gives the bits of
    a cold entry, and each lane the bits of the single-graph step."""
    monkeypatch.setattr(RefineManyProgram, "ROWS", 8)
    kw = dict(min_dist=2e-3, lanes_min=2)
    bucketing.STEP_CACHE.clear()
    bucketing.refine_level_many(_requests(mode, engine, [(2, 3, 12)]),
                                ideal_len=1.0, rep_const=1.0, **kw)
    new = [(7, 5, 21), (9, 6, 13)]
    warm = bucketing.refine_level_many(_requests(mode, engine, new),
                                       ideal_len=1.7, rep_const=0.6, **kw)
    assert bucketing.cache_stats() == dict(entries=1, hits=1, misses=1)
    bucketing.STEP_CACHE.clear()
    cold = bucketing.refine_level_many(_requests(mode, engine, new),
                                       ideal_len=1.7, rep_const=0.6, **kw)
    for w, c, r in zip(warm, cold, _requests(mode, engine, new)):
        assert torch.equal(w, c)
        single = bucketing.refine_level(r.g, r.pos0, r.sched, ideal_len=1.7,
                                        rep_const=0.6, min_dist=2e-3,
                                        seed=r.seed)
        assert torch.equal(w, single)
    assert not torch.equal(warm[0][:10], warm[1][:10])


# -- the wave scheduler ---------------------------------------------------------------

SCHED_GRAPHS = [G.delaunay(150, 50 + i) for i in range(3)]
# three levels a graph (150 → ~15 → ~2), so a job is still in flight when
# another joins; short schedules keep the CPU runs quick
SCHED_CFG = LayoutConfig(seed=3, coarsest_threshold=10, coarsest_iters=60,
                         finest_iters=20)
_DEDICATED = {}


def _dedicated(i, cfg):
    key = (i, cfg)
    if key not in _DEDICATED:
        _DEDICATED[key] = _sequential(*SCHED_GRAPHS[i], cfg)[0]
    return _DEDICATED[key]


def test_scheduler_mid_flight_admit_and_remove():
    cfg = SCHED_CFG
    sch = WaveScheduler(cfg, device="cpu")
    j0 = sch.admit(*SCHED_GRAPHS[0])
    j1 = sch.admit(*SCHED_GRAPHS[1])
    assert sch.step()["lanes"] == 2
    sch.remove(j1)                               # cancelled mid-flight
    assert sch.step()["lanes"] == 1
    j2 = sch.admit(*SCHED_GRAPHS[2])             # joins between steps
    assert isinstance(j2, GraphJob) and sch.lanes_live() == 2
    sch.drain()
    assert not sch.active and sch.waves == 5
    assert [t.stats.levels for t in j0.tasks + j2.tasks] == [3, 3]
    assert np.array_equal(j0.result()[0], _dedicated(0, cfg))
    assert np.array_equal(j2.result()[0], _dedicated(2, cfg))
    with pytest.raises(RuntimeError):
        j1.result()


def test_scheduler_max_lanes_preempts_in_order():
    cfg = SCHED_CFG
    sch = WaveScheduler(cfg, device="cpu")
    jobs = [sch.admit(*g) for g in SCHED_GRAPHS]
    levels = [j.tasks[0]._level for j in jobs]
    out = sch.step(order=lambda j: -j.uid, max_lanes=1)
    assert out["lanes"] == 1 and out["preempted"] == 2
    # only the first job in the order (the last admitted) moved on
    assert [j.tasks[0]._level for j in jobs] == levels[:2] + [levels[2] - 1]
    assert sch.lane_dispatches == 1
    sch.drain()
    for i, j in enumerate(jobs):
        assert np.array_equal(j.result()[0], _dedicated(i, cfg))


def test_scheduler_counts_straggler_waves_on_a_virtual_clock():
    """Waves timed on a VirtualClock that the dispatch advances by scripted
    seconds: the straggler count is the JAX package's StepTimer's over the
    same seconds, the clock read every wave, each result equal to its
    dedicated run; Timer times the drain."""
    from repro.utils.timing import StepTimer as JaxStepTimer
    from repro_torch.obs.clock import VirtualClock
    from repro_torch.utils.timing import Timer

    cfg = SCHED_CFG
    vc = VirtualClock(t0=5.0)
    secs = [1.0, 1.0, 9.0]               # the third wave is a straggler
    timed = set()

    def dispatch(reqs):
        if sch.waves not in timed:       # one advance a wave, not a group
            timed.add(sch.waves)
            vc.advance(secs[sch.waves])
        return bucketing.refine_level_many(reqs, ideal_len=cfg.ideal_len,
                                           rep_const=cfg.rep_const)

    sch = WaveScheduler(cfg, device="cpu", clock=vc, dispatch=dispatch)
    jobs = [sch.admit(*g) for g in SCHED_GRAPHS]
    with Timer() as t:
        sch.drain()
    assert sch.waves == len(secs) and vc.now() == 5.0 + sum(secs)
    ref = JaxStepTimer()
    assert sch.straggler_waves == sum(ref.record(x) for x in secs) == 1
    assert t.seconds > 0
    with pytest.raises(ValueError):
        vc.advance(-1.0)
    for i, j in enumerate(jobs):
        assert np.array_equal(j.result()[0], _dedicated(i, cfg))


def test_many_rejects_unsupported_configs():
    g = [G.grid(6, 6)]
    for cfg in (LayoutConfig(engine="flat"), LayoutConfig(bucketing=False),
                LayoutConfig(driver="centralized"),
                LayoutConfig(driver="multigila_dist")):
        with pytest.raises(ValueError):
            multigila_layout_many(g, cfg, device="cpu")
    for kw in (dict(seeds=[1, 2]), dict(engines=["gila", "gila"]),
               dict(weights=[None, None])):
        with pytest.raises(ValueError):
            multigila_layout_many(g, LayoutConfig(), device="cpu", **kw)
    with pytest.raises(ValueError):
        multigila_layout_many(g, LayoutConfig(), device="cpu",
                              weights=[np.ones(3, np.float32)])
