"""Port parity of refinement and of the whole main path against the live JAX
package on the CPU.

Float outputs of a force-directed layout cannot be held bit for bit: the two
frameworks sum forces in other orders, and the iteration amplifies last-bit
differences wherever forces nearly cancel. Measured on these inputs, the
port's distance from JAX is of the order of JAX's own distance from a rerun
with pos0 moved by one float32 ulp (both ≤ 0.0015). So:

* refine (20 iterations from the same pos0, at a temperature that keeps the
  dynamics well conditioned): median |Δpos| ≤ 1e-4 and max |Δpos| ≤ 0.01,
  in layout units where the ideal edge length is 1;
* end to end: level sizes equal exactly (the hierarchy is integer-only) and
  quality_report NELD within 0.05, CRE within 0.15 of JAX's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import jax.numpy as jnp

from repro.core import bucketing as jax_bucketing
from repro.core import multigila_layout as jax_layout
from repro.core import schedule as jax_schedule
from repro.core.multilevel import LayoutConfig as JaxConfig
from repro.graphs import generators as G
from repro.graphs.graph import build_graph as jax_build_graph
from repro.graphs.metrics import quality_report as jax_quality
from repro_torch.core import bucketing, schedule
from repro_torch.core import LayoutConfig, multigila_layout
from repro_torch.graphs.graph import build_graph
from repro_torch.graphs.metrics import quality_report

NELD_DELTA, CRE_DELTA = 0.05, 0.15
THREE_MODES = dict(exact_threshold=64, grid_threshold=512)


@pytest.mark.parametrize("mode,kw", [
    ("exact", dict(exact_threshold=10 ** 6)),
    ("neighbor", dict(exact_threshold=64, grid_threshold=10 ** 6)),
    ("grid", THREE_MODES)])
def test_refine_level_matches_jax(mode, kw):
    n0 = 2000
    edges, n = G.delaunay(n0, seed=1)
    # the Delaunay points themselves, at unit edge length: a near-equilibrium
    # start, as placement hands a level to refinement
    pts = np.random.default_rng(1).random((n0, 2)) * np.sqrt(n0)
    gj = jax_build_graph(edges, n, bucket=True)
    gt = build_graph(edges, n, bucket=True, device="cpu")
    pos0 = np.zeros((gj.n_pad, 2), np.float32)
    pos0[:n] = pts
    sj = jax_schedule.make_schedule(0, 3, gj.n, gj.m, n_pad=gj.n_pad, **kw)
    st = schedule.make_schedule(0, 3, gt.n, gt.m, n_pad=gt.n_pad, **kw)
    assert sj.mode == st.mode == mode
    assert (sj.k, sj.cap, sj.grid_dim, sj.cell_cap) == (st.k, st.cap,
                                                        st.grid_dim,
                                                        st.cell_cap)
    sj = dataclasses.replace(sj, iters=20, temp0=0.05)
    st = dataclasses.replace(st, iters=20, temp0=0.05)
    pj = np.asarray(jax_bucketing.refine_level(
        gj, jnp.asarray(pos0), sj, ideal_len=1.0, rep_const=1.0, seed=3))
    pt = bucketing.refine_level(gt, torch.from_numpy(pos0), st,
                                ideal_len=1.0, rep_const=1.0, seed=3).numpy()
    d = np.abs(pj - pt).max(axis=1)
    assert np.isfinite(pt).all()
    assert float(np.median(d)) <= 1e-4, np.quantile(d, [0.5, 0.99, 1.0])
    assert float(d.max()) <= 0.01, np.quantile(d, [0.5, 0.99, 1.0])
    assert np.abs(pt - pos0).max() > 0.2          # it did move


def _layout_cases():
    suite = {name: (e, n) for name, e, n in G.regulargraphs_suite(small=True)}
    cases = [pytest.param(*suite[k], {}, id=k)
             for k in ("grid_8_8", "tree_3_3", "flower_4_5", "rnd_64_4")]
    cases.append(pytest.param(*G.delaunay(3000, seed=1), THREE_MODES,
                              id="delaunay_3000_three_modes"))
    return cases


@pytest.mark.parametrize("edges,n,kw", _layout_cases())
def test_multigila_layout_matches_jax(edges, n, kw):
    pj, sj = jax_layout(edges, n, JaxConfig(**kw))
    pt, st = multigila_layout(edges, n, LayoutConfig(**kw), device="cpu")
    assert pt.shape == (n, 2) and np.isfinite(pt).all()
    assert st.level_sizes == sj.level_sizes
    if kw:
        assert set(st.level_modes) == {"exact", "neighbor", "grid"}
    qj = jax_quality(jax_build_graph(edges, n), pj)
    qt = quality_report(build_graph(edges, n, device="cpu"), pt)
    assert abs(qt["neld"] - qj["neld"]) <= NELD_DELTA, (qt, qj)
    assert abs(qt["cre"] - qj["cre"]) <= CRE_DELTA, (qt, qj)


def test_disconnected_input_packs_components():
    e1, n1 = G.grid(5, 5)
    e2, n2 = G.tree(2, 3)
    edges = np.concatenate([e1, e2 + n1])
    n = n1 + n2 + 1                               # plus one isolated vertex
    pj, _ = jax_layout(edges, n, JaxConfig())
    pt, st = multigila_layout(edges, n, LayoutConfig(), device="cpu")
    assert pt.shape == (n, 2) and np.isfinite(pt).all()
    # the same shelf packing: component boxes land in the same places
    for vs in (np.arange(n1), np.arange(n1, n1 + n2)):
        np.testing.assert_allclose(pt[vs].min(0), pj[vs].min(0), atol=0.5)
    assert st.levels >= 1


def test_unported_driver_and_engine_raise():
    """What the drivers do not take raises: an unknown driver (ValueError,
    from the config and from the CLI's choices), and a sharded mesh whose
    size is not the world size (ValueError, from the config and from the
    CLI's ``--mesh``; this process has one rank and no group). An unknown
    engine is a ValueError, as in JAX. The sharded driver itself is held to
    JAX in ``test_torch_distributed.py``."""
    from repro_torch.launch.layout import main
    edges, n = G.grid(4, 4)
    with pytest.raises(ValueError, match="unknown driver"):
        multigila_layout(edges, n, LayoutConfig(driver="nope"),
                         device="cpu")
    for cfg in (LayoutConfig(driver="multigila_dist", mesh_shape=(2, 2)),
                LayoutConfig(engine="multigila_dist", mesh_shape=(4, 1))):
        with pytest.raises(ValueError, match="ranks"):
            multigila_layout(edges, n, cfg, device="cpu")
    base = ["--graph", "grid", "--args", "4", "4", "--device", "cpu"]
    with pytest.raises(ValueError, match="ranks"):
        main(base + ["--driver", "multigila_dist", "--mesh", "2x2"])
    with pytest.raises(SystemExit):
        main(base + ["--driver", "nope"])
    with pytest.raises(ValueError, match="unknown refinement engine"):
        multigila_layout(edges, n, LayoutConfig(engine="nope"), device="cpu")


def test_neighbor_lists_equal_jax():
    from repro.core.gila import build_level_neighbors as jax_lists
    from repro_torch.core.gila import build_level_neighbors
    edges, n = G.delaunay(1200, seed=6)
    gj = jax_build_graph(edges, n, bucket=True)
    gt = build_graph(edges, n, bucket=True, device="cpu")
    for k, cap in ((2, 32), (4, 192)):
        ij, mj = jax_lists(gj, k, cap, seed=9)
        it, mt = build_level_neighbors(gt, k, cap, seed=9)
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
        np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
