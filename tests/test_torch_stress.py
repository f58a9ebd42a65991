"""The port's refinement-engine seam and maxent-stress engine against the
live JAX package on the CPU, with edge weights end to end.

Tolerances:

* stress refine (20 iterations at temperature 0.5 from the same pos0 on a
  weighted 2000-vertex delaunay, in each repulsion mode): median |Δpos| ≤
  1e-5 and max |Δpos| ≤ 1e-3 in layout units (ideal edge length 1).
  Measured: the port is within 2.7e-4 of JAX (median ≤ 1.9e-6), and JAX
  is within 6.7e-5 (exact), 2.5e-3 (neighbor) and 6.1e-5 (grid) of its own
  rerun from a pos0 moved by one float32 ulp (median 3.8e-6): the two
  frameworks sum forces in other orders, which moves a position by the
  order of a one-ulp rerun;
* the weighted hierarchy is integer and compounded-weight arithmetic done
  in the same order: bit-identical, ``ewt`` included;
* whole layouts: quality_report NELD within 0.05 and CRE within 0.15 of
  JAX's, as in ``test_torch_layout.py``.
"""
import dataclasses
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import jax.numpy as jnp

from repro.core import bucketing as jax_bucketing
from repro.core import multigila_layout as jax_layout
from repro.core import schedule as jax_schedule
from repro.core import engine as jax_engine
from repro.core import stress as jax_stress
from repro.core import multilevel as jax_ml
from repro.core.pruning import prune_degree_one as jax_prune
from repro.graphs import generators as G
from repro.graphs.graph import build_graph as jax_build_graph
from repro.graphs.metrics import quality_report as jax_quality
from repro_torch.core import LayoutConfig, multigila_layout
from repro_torch.core import bucketing, engine, schedule, stress
from repro_torch.core import multilevel as ml
from repro_torch.core.pruning import prune_degree_one
from repro_torch.graphs.graph import build_graph
from repro_torch.graphs.metrics import quality_report

NELD_DELTA, CRE_DELTA = 0.05, 0.15
INFO_FIELDS = ("parent_coarse", "sun_of", "depth", "state", "sun_pos_index")
GRAPH_FIELDS = ("src", "dst", "vmask", "emask", "mass", "ewt")


def _weights(m, seed):
    return np.random.default_rng(seed).uniform(0.5, 2.0, m).astype(np.float32)


# -- the engine registry seam --------------------------------------------------

def test_engine_registry_matches_jax():
    for name in ("gila", "stress"):
        ej, et = jax_engine.get_engine(name), engine.get_engine(name)
        assert (et.name, et.sched_k) == (ej.name, ej.sched_k)
    assert sorted(engine.ENGINES) == sorted(jax_engine.ENGINES)
    for get in (jax_engine.get_engine, engine.get_engine):
        with pytest.raises(ValueError, match="unknown refinement engine"):
            get("nope")


def test_stress_is_imported_on_first_use_only():
    """Importing the package registers gila only; naming 'stress' loads and
    registers core/stress.py."""
    code = ("import sys, repro_torch.core as c\n"
            "from repro_torch.core import engine\n"
            "assert 'repro_torch.core.stress' not in sys.modules\n"
            "assert sorted(engine.ENGINES) == ['gila']\n"
            "assert engine.get_engine('stress').name == 'stress'\n"
            "assert 'repro_torch.core.stress' in sys.modules\n"
            "assert 'jax' not in sys.modules\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=120)


@pytest.mark.parametrize("iters", [10, 50, 122, 300])
def test_lane_schedule_matches_jax(iters):
    assert stress.alpha_schedule(iters) == jax_stress.alpha_schedule(iters)
    sj = jax_schedule.make_schedule(1, 4, 900, 2500, n_pad=1024,
                                    engine="stress")
    st = schedule.make_schedule(1, 4, 900, 2500, n_pad=1024, engine="stress")
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    sj, st = (dataclasses.replace(s, iters=iters) for s in (sj, st))
    assert (engine.get_engine("stress").lane_schedule(st)
            == jax_engine.get_engine("stress").lane_schedule(sj))


@pytest.mark.parametrize("kw", [dict(), dict(engine="stress"),
                                dict(engine="flat"),
                                dict(engine="centralized", seed=3),
                                dict(driver="flat", engine="stress")])
def test_layoutconfig_driver_engine_shim_matches_jax(kw):
    cj, ct = jax_ml.LayoutConfig(**kw), LayoutConfig(**kw)
    assert (ct.driver, ct.engine, ct.seed) == (cj.driver, cj.engine, cj.seed)
    cj, ct = (dataclasses.replace(c, seed=9) for c in (cj, ct))
    assert (ct.driver, ct.engine) == (cj.driver, cj.engine)


# -- stress refinement from one pos0 ---------------------------------------------

@pytest.mark.parametrize("mode,kw", [
    ("exact", dict(exact_threshold=10 ** 6)),
    ("neighbor", dict(exact_threshold=64, grid_threshold=10 ** 6)),
    ("grid", dict(exact_threshold=64, grid_threshold=512))])
def test_stress_refine_level_matches_jax(mode, kw):
    n0 = 2000
    edges, n = G.delaunay(n0, seed=1)
    w = _weights(len(edges), 2)
    pts = np.random.default_rng(1).random((n0, 2)) * np.sqrt(n0)
    gj = jax_build_graph(edges, n, bucket=True, ewt=w)
    gt = build_graph(edges, n, bucket=True, ewt=w, device="cpu")
    pos0 = np.zeros((gj.n_pad, 2), np.float32)
    pos0[:n] = pts
    sj = jax_schedule.make_schedule(0, 3, gj.n, gj.m, n_pad=gj.n_pad,
                                    engine="stress", **kw)
    st = schedule.make_schedule(0, 3, gt.n, gt.m, n_pad=gt.n_pad,
                                engine="stress", **kw)
    assert sj.mode == st.mode == mode
    assert dataclasses.asdict(st) == dataclasses.asdict(sj)
    sj = dataclasses.replace(sj, iters=20, temp0=0.5)
    st = dataclasses.replace(st, iters=20, temp0=0.5)
    pj = np.asarray(jax_bucketing.refine_level(
        gj, jnp.asarray(pos0), sj, ideal_len=1.0, rep_const=1.0, seed=3))
    pt = bucketing.refine_level(gt, torch.from_numpy(pos0), st,
                                ideal_len=1.0, rep_const=1.0, seed=3).numpy()
    d = np.abs(pj - pt).max(axis=1)
    assert np.isfinite(pt).all()
    assert float(np.median(d)) <= 1e-5, np.quantile(d, [0.5, 0.99, 1.0])
    assert float(d.max()) <= 1e-3, np.quantile(d, [0.5, 0.99, 1.0])
    assert np.abs(pt - pos0).max() > 2.0          # it did move
    assert (pt[n:] == 0).all()                     # padding stays at 0


# -- weights through pruning and the hierarchy ---------------------------------

def _weighted_cases():
    e1, n1 = G.delaunay(3000, seed=1)
    e2, n2 = G.with_degree_one_fringe(*G.scale_free(1500, 2, seed=4),
                                      frac=0.3, seed=5)
    e3, n3 = G.grid(12, 9)
    return [pytest.param(e1, n1, 7, id="delaunay_3000"),
            pytest.param(e2, n2, 8, id="scale_free_fringe"),
            pytest.param(e3, n3, 9, id="grid_12_9")]


@pytest.mark.parametrize("edges,n,seed", _weighted_cases())
def test_weighted_hierarchy_bit_identical(edges, n, seed):
    w = _weights(len(edges), seed)
    prj, prt = jax_prune(edges, n, weights=w), prune_degree_one(edges, n,
                                                                weights=w)
    np.testing.assert_array_equal(prt.edges, prj.edges)
    np.testing.assert_array_equal(prt.ewt, prj.ewt)
    gj = jax_build_graph(prj.edges, prj.n, mass=prj.mass, ewt=prj.ewt,
                         bucket=True)
    gt = build_graph(prt.edges, prt.n, mass=prt.mass, ewt=prt.ewt,
                     bucket=True, device="cpu")
    hj = jax_ml.build_hierarchy(gj, jax_ml.LayoutConfig(seed=seed))
    ht = ml.build_hierarchy(gt, LayoutConfig(seed=seed), device="cpu")
    assert len(hj[0]) >= 2
    assert [(g.n, g.m) for g in ht[0]] == [(g.n, g.m) for g in hj[0]]
    for a, b in zip(hj[0], ht[0]):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)),
                                          err_msg=f)
    for a, b in zip(hj[1], ht[1]):
        for f in INFO_FIELDS:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)),
                                          err_msg=f)
    # the coarse weights are compounded path lengths, not all 1
    assert any(float(g.ewt[g.emask].max()) > 2.0 for g in ht[0][1:])


# -- whole layouts ---------------------------------------------------------------

def _quality(edges, n, pj, pt):
    qj = jax_quality(jax_build_graph(edges, n), pj)
    qt = quality_report(build_graph(edges, n, device="cpu"), pt)
    return qj, qt


def _suite():
    return [pytest.param(e, n, id=name)
            for name, e, n in G.regulargraphs_suite(small=True)]


@pytest.mark.parametrize("edges,n", _suite())
def test_stress_quality_suite_matches_jax(edges, n):
    pj, sj = jax_layout(edges, n, jax_ml.LayoutConfig(seed=0,
                                                      engine="stress"))
    pt, st = multigila_layout(edges, n, LayoutConfig(seed=0, engine="stress"),
                              device="cpu")
    assert pt.shape == (n, 2) and np.isfinite(pt).all()
    assert st.level_sizes == sj.level_sizes
    qj, qt = _quality(edges, n, pj, pt)
    assert abs(qt["neld"] - qj["neld"]) <= NELD_DELTA, (qt, qj)
    assert abs(qt["cre"] - qj["cre"]) <= CRE_DELTA, (qt, qj)


def test_weighted_edge_lengths_track_weights():
    """ℓ_e = w_e·L: under the stress engine the drawn edge lengths follow
    the weights (r > 0.5, as the JAX package's own test asks), in the port
    as in JAX, and the weighted drawings score alike."""
    edges, n = G.grid(10, 10)
    w = _weights(len(edges), 0)
    pj, _ = jax_layout(edges, n, jax_ml.LayoutConfig(seed=1, engine="stress"),
                       weights=w)
    pt, _ = multigila_layout(edges, n, LayoutConfig(seed=1, engine="stress"),
                             weights=w, device="cpu")
    pu, _ = multigila_layout(edges, n, LayoutConfig(seed=1, engine="stress"),
                             device="cpu")
    assert not np.array_equal(pu, pt), "weights must reach the layout"
    r = {}
    for k, p in (("jax", pj), ("port", pt)):
        lens = np.linalg.norm(p[edges[:, 0]] - p[edges[:, 1]], axis=1)
        r[k] = float(np.corrcoef(w, lens)[0, 1])
    assert r["port"] > 0.5 and r["jax"] > 0.5, r
    assert abs(r["port"] - r["jax"]) <= 0.05, r
    qj, qt = _quality(edges, n, pj, pt)
    assert abs(qt["neld"] - qj["neld"]) <= NELD_DELTA, (qt, qj)


def test_weighted_disconnected_input_slices_weights():
    """Weights are sliced per component: a two-component weighted graph
    draws each component as JAX does."""
    e1, n1 = G.grid(6, 6)
    e2, n2 = G.delaunay(300, seed=2)
    edges = np.concatenate([e2 + n1, e1])            # components interleaved
    n = n1 + n2
    w = _weights(len(edges), 3)
    cfg = dict(seed=2, engine="stress")
    pj, _ = jax_layout(edges, n, jax_ml.LayoutConfig(**cfg), weights=w)
    pt, _ = multigila_layout(edges, n, LayoutConfig(**cfg), weights=w,
                             device="cpu")
    for vs, ce, cw in ((np.arange(n1), e1, w[len(e2):]),
                       (np.arange(n1, n), e2, w[:len(e2)])):
        lens = {k: np.linalg.norm(p[vs][ce[:, 0]] - p[vs][ce[:, 1]], axis=1)
                for k, p in (("jax", pj), ("port", pt))}
        r = {k: float(np.corrcoef(cw, v)[0, 1]) for k, v in lens.items()}
        assert abs(r["port"] - r["jax"]) <= 0.1, r
        np.testing.assert_allclose(pt[vs].min(0), pj[vs].min(0), atol=1.0)
