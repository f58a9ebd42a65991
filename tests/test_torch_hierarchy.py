"""Port parity of the hierarchy (solar merger + next_level) and the placer
against the live JAX package on the CPU.

The hierarchy is integer-only, so it must be bit-identical: level sizes,
every coarse graph array and every ``LevelInfo`` array.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.core import multilevel as jax_ml
from repro.core import solar_merger as jax_merger
from repro.core.solar_placer import solar_placer as jax_placer
from repro.graphs import generators as G
from repro.graphs.graph import build_graph as jax_build_graph
from repro_torch import convert
from repro_torch.core import multilevel as ml
from repro_torch.core import solar_merger
from repro_torch.core.pruning import prune_degree_one
from repro_torch.core.solar_placer import solar_placer
from repro_torch.graphs.graph import build_graph

INFO_FIELDS = ("parent_coarse", "sun_of", "depth", "state", "sun_pos_index")
GRAPH_FIELDS = ("src", "dst", "vmask", "emask", "mass", "ewt")


def _pruned(edges, n):
    pr = prune_degree_one(edges, n)
    return pr.edges, pr.n, pr.mass


def _assert_hierarchies_equal(jax_h, port_h):
    (gj, ij), (gt, it) = jax_h, port_h
    assert [(g.n, g.m) for g in gj] == [(g.n, g.m) for g in gt]
    for a, b in zip(gj, gt):
        for f in GRAPH_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy(), err_msg=f)
    for a, b in zip(ij, it):
        for f in INFO_FIELDS:
            np.testing.assert_array_equal(np.asarray(getattr(a, f)),
                                          getattr(b, f).numpy(), err_msg=f)


def _cases():
    cases = list(G.regulargraphs_suite(small=True))
    cases.append(("delaunay_3000", *G.delaunay(3000, seed=1)))
    return [pytest.param(e, n, id=name) for name, e, n in cases]


@pytest.mark.parametrize("edges,n", _cases())
def test_build_hierarchy_bit_identical(edges, n):
    e, nw, mass = _pruned(edges, n)
    gj = jax_build_graph(e, nw, mass=mass, bucket=True)
    gt = build_graph(e, nw, mass=mass, bucket=True, device="cpu")
    _assert_hierarchies_equal(
        jax_ml.build_hierarchy(gj, jax_ml.LayoutConfig()),
        ml.build_hierarchy(gt, ml.LayoutConfig(), device="cpu"))


def test_build_hierarchy_deep_unpruned():
    """No pruning and a low halting threshold: more merger levels, with
    degree-1 vertices, desperation rounds and coarse edge weights."""
    edges, n = G.scale_free(2500, 2, seed=4)
    cfg_j = jax_ml.LayoutConfig(coarsest_threshold=8, seed=5)
    cfg_t = ml.LayoutConfig(coarsest_threshold=8, seed=5)
    gj = jax_build_graph(edges, n, bucket=True)
    gt = build_graph(edges, n, bucket=True, device="cpu")
    hj = jax_ml.build_hierarchy(gj, cfg_j)
    assert len(hj[0]) >= 3
    _assert_hierarchies_equal(hj, ml.build_hierarchy(gt, cfg_t, device="cpu"))


def test_merger_from_converted_state_matches_host_driver():
    """One merger run and next_level through ``convert``: the JAX package's
    per-round host driver is the reference."""
    edges, n = G.delaunay(1500, seed=9)
    gj = jax_build_graph(edges, n, bucket=True)
    gt = convert.padded_graph(*(np.asarray(getattr(gj, f))
                                for f in GRAPH_FIELDS), gj.n, gj.m,
                              device="cpu")
    stj = jax_merger.run_merger_host(gj, seed=11)
    stt = solar_merger.run_merger(gt, seed=11)
    for f in ("state", "sun", "depth", "parent"):
        np.testing.assert_array_equal(np.asarray(getattr(stj, f)),
                                      getattr(stt, f).numpy(), err_msg=f)
    cgj, infoj = jax_merger.next_level_host(gj, stj, bucket=True)
    st_conv = convert.merger_state(*(np.asarray(getattr(stj, f)) for f in
                                     ("state", "sun", "depth", "parent")),
                                   device="cpu")
    cgt, infot = solar_merger.next_level(gt, st_conv)
    _assert_hierarchies_equal(([cgj], [infoj]), ([cgt], [infot]))


@pytest.mark.parametrize("seed", [0, 4])
def test_placer_matches_jax(seed):
    """Same hierarchy, same coarse drawing → same placement. Tolerance
    1e-5 · extent: the scatter angles' cos/sin and XLA's fused multiply-adds
    round differently from torch's in the last float32 bit."""
    edges, n = G.delaunay(2000, seed=seed)
    gj = jax_build_graph(edges, n, bucket=True)
    hj = jax_ml.build_hierarchy(gj, jax_ml.LayoutConfig(seed=seed))
    g1 = hj[0][1]
    rng = np.random.default_rng(seed)
    coarse = np.zeros((g1.n_pad, 2), np.float32)
    coarse[:g1.n] = rng.uniform(-20, 20, (g1.n, 2))
    info = hj[1][0]
    pj = np.asarray(jax_placer(gj, info, jnp.asarray(coarse), seed=seed + 3,
                               scatter_scale=0.5))
    gt = build_graph(edges, n, bucket=True, device="cpu")
    it = convert.level_info(*(np.asarray(getattr(info, f))
                              for f in INFO_FIELDS), device="cpu")
    pt = solar_placer(gt, it, torch.from_numpy(coarse), seed=seed + 3,
                      scatter_scale=0.5).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=1e-5 * 20)
    # suns sit exactly on their coarse position
    suns = np.asarray(info.sun_pos_index)
    np.testing.assert_array_equal(pt[suns], coarse[:g1.n])
