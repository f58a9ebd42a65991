"""The port's single-graph drivers (``flat``, ``centralized``, unpruned
``multigila``), graph I/O and layout CLI against the live JAX package on
the CPU.

I/O is host numpy in both packages, so files, edges, weights and SVG bytes
must be equal. Layouts are held as in ``test_torch_layout.py``: level sizes
equal exactly (the hierarchy is integer-only) and quality_report NELD
within 0.05, CRE within 0.15 of JAX's on the same graph and seed.
"""
import contextlib
import dataclasses
import io

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.core import multigila_layout as jax_layout
from repro.core.multilevel import LayoutConfig as JaxConfig
from repro.graphs import generators as G
from repro.graphs import io as jax_io
from repro.graphs.graph import build_graph as jax_build_graph
from repro.graphs.metrics import quality_report as jax_quality
from repro.launch import layout as jax_cli
from repro_torch.core import LayoutConfig, multigila_layout
from repro_torch.graphs import generators
from repro_torch.graphs import io as graph_io
from repro_torch.graphs.graph import build_graph
from repro_torch.graphs.metrics import quality_report
from repro_torch.launch import layout as cli

NELD_DELTA, CRE_DELTA = 0.05, 0.15


# -- graph I/O -------------------------------------------------------------------

_FILES = {
    "plain.txt": "# c\n0 1\n\n% c2\n1 2\n2 3 0.5\n",
    "weighted.txt": "# comment\n0 1 2.5\n1 2\n2 3 0.5\n7 4 1e-2\n",
    "pattern.mtx": ("%%MatrixMarket matrix coordinate pattern symmetric\n"
                    "% comment\n7 7 3\n1 2\n2 3\n4 5\n"),
    "real.mtx": ("%%MatrixMarket matrix coordinate real general\n"
                 "9 9 3\n1 2 4.0\n2 3 0.25\n5 8 3\n"),
    "empty.txt": "",
    "empty.mtx": "%%MatrixMarket matrix coordinate real general\n6 6 0\n",
    "flat.txt": "0\n1\n1\n2\n",
}


@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("name", sorted(_FILES))
def test_load_edgelist_matches_jax(tmp_path, name, weights):
    p = tmp_path / name
    p.write_text(_FILES[name])
    got = graph_io.load_edgelist(str(p), weights=weights)
    want = jax_io.load_edgelist(str(p), weights=weights)
    assert len(got) == len(want) == (3 if weights else 2)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].dtype == want[0].dtype == np.int64
    assert got[1] == want[1]
    if weights:
        np.testing.assert_array_equal(got[2], want[2])
        assert got[2].dtype == want[2].dtype == np.float32


def test_save_edgelist_and_svg_match_jax(tmp_path):
    rng = np.random.default_rng(0)
    edges = rng.integers(0, 500, (2000, 2))
    pos = rng.random((500, 2)).astype(np.float32)
    graph_io.save_edgelist(str(tmp_path / "a.txt"), edges)
    jax_io.save_edgelist(str(tmp_path / "b.txt"), edges)
    assert (tmp_path / "a.txt").read_bytes() == (tmp_path / "b.txt"
                                                 ).read_bytes()
    np.testing.assert_array_equal(
        graph_io.load_edgelist(str(tmp_path / "a.txt"))[0], edges)
    for cap in (64, 200_000):
        graph_io.save_svg(str(tmp_path / "a.svg"), pos, edges, max_edges=cap)
        jax_io.save_svg(str(tmp_path / "b.svg"), pos, edges, max_edges=cap)
        assert (tmp_path / "a.svg").read_bytes() == (tmp_path / "b.svg"
                                                     ).read_bytes()


@pytest.mark.parametrize("name,args", [("grid", [8, 5]),
                                       ("delaunay", [300.0, 2]),
                                       ("gnp", [80, 3.5, 1])])
def test_from_cli_matches_jax(name, args):
    e, n, a = generators.from_cli(name, args)
    ej, nj, aj = G.from_cli(name, args)
    np.testing.assert_array_equal(e, ej)
    assert (n, a) == (nj, aj)
    assert [type(x) for x in a] == [type(x) for x in aj]


# -- the drivers -------------------------------------------------------------------

def _graphs():
    suite = {name: (e, n) for name, e, n in G.regulargraphs_suite(small=True)}
    return [pytest.param(*suite[k], id=k)
            for k in ("grid_8_8", "tree_3_3", "flower_4_5", "rnd_64_4")]


def _assert_matches(edges, n, kw, *, weights=None):
    pj, sj = jax_layout(edges, n, JaxConfig(**kw), weights=weights)
    pt, st = multigila_layout(edges, n, LayoutConfig(**kw), weights=weights,
                              device="cpu")
    assert pt.shape == (n, 2) and np.isfinite(pt).all()
    assert st.levels == sj.levels
    assert st.level_sizes == sj.level_sizes
    assert set(st.phase_seconds) == {"coarsen", "place", "refine", "compile"}
    qj = jax_quality(jax_build_graph(edges, n), pj)
    qt = quality_report(build_graph(edges, n, device="cpu"), pt)
    assert abs(qt["neld"] - qj["neld"]) <= NELD_DELTA, (qt, qj)
    assert abs(qt["cre"] - qj["cre"]) <= CRE_DELTA, (qt, qj)
    return st


@pytest.mark.parametrize("edges,n", _graphs())
@pytest.mark.parametrize("kw", [dict(driver="flat"),
                                dict(driver="centralized"),
                                dict(prune=False),
                                dict(driver="flat", engine="stress"),
                                dict(driver="centralized", engine="stress")],
                         ids=["flat", "centralized", "unpruned",
                              "flat_stress", "centralized_stress"])
def test_driver_matches_jax(edges, n, kw):
    st = _assert_matches(edges, n, kw)
    if kw.get("driver") == "flat":
        assert st.levels == 1 and st.phase_seconds["place"] == 0.0
    if kw.get("driver") == "centralized":
        assert set(st.level_modes) == {"exact"}


def test_flat_grid_level_and_centralized_hierarchy_match_jax():
    """delaunay(400) with thresholds (32, 256): centralized turns both
    levels of its hierarchy exact; flat runs one grid level (100 iterations
    here) from a random init.

    That flat run is chaotic: when its random init moves by one float32
    ulp, JAX's own final CRE moves by up to 0.39 and NELD by up to 0.014
    (seeds 0–2), and the port's distance from JAX tracks JAX's distance
    from that rerun as the iterations go (max |Δpos| after 5 iterations:
    port 0.0012, JAX's one-ulp rerun 0.0023; after 10: 2.3 and 3.4). So
    flat's final CRE is not compared here; its random init must be
    bit-identical, its first 5 iterations within 0.05, and its final NELD
    within 0.05."""
    from repro.core import bucketing as jax_bucketing
    from repro.core import gila as jax_gila
    from repro_torch.core import bucketing, gila
    from repro_torch.core.multilevel import _schedule

    edges, n = G.delaunay(400, seed=1)
    three = dict(exact_threshold=32, grid_threshold=256)
    st = _assert_matches(edges, n, dict(driver="centralized", **three))
    assert len(st.level_modes) >= 2 and set(st.level_modes) == {"exact"}

    cfg = dict(driver="flat", coarsest_iters=100, **three)
    pj, sj = jax_layout(edges, n, JaxConfig(**cfg))
    pt, st = multigila_layout(edges, n, LayoutConfig(**cfg), device="cpu")
    assert np.isfinite(pt).all()
    assert (st.level_sizes, st.level_modes) == (sj.level_sizes, ("grid",))
    qj = jax_quality(jax_build_graph(edges, n), pj)
    qt = quality_report(build_graph(edges, n, device="cpu"), pt)
    assert abs(qt["neld"] - qj["neld"]) <= NELD_DELTA, (qt, qj)

    gj = jax_build_graph(edges, n, bucket=True)
    gt = build_graph(edges, n, bucket=True, device="cpu")
    scale = max(n, 4) ** 0.5
    p0 = gila.random_init(gt, scale, 0)
    np.testing.assert_array_equal(p0.numpy(), np.asarray(
        jax_gila.random_init(gj, scale, 0)))
    sched = dataclasses.replace(_schedule(LayoutConfig(**cfg), 0, 1, gt),
                                iters=5)
    a = np.asarray(jax_bucketing.refine_level(
        gj, p0.numpy(), sched, ideal_len=1.0, rep_const=1.0, seed=0))
    b = bucketing.refine_level(gt, p0, sched, ideal_len=1.0, rep_const=1.0,
                               seed=0).numpy()
    assert np.abs(a - b).max() <= 0.05


def test_unpruned_weighted_matches_jax():
    """prune=False hands the weights to the graph unchanged, the degree-one
    vertices included."""
    edges, n = G.with_degree_one_fringe(*G.grid(7, 7), frac=0.3, seed=1)
    w = np.random.default_rng(4).uniform(0.5, 2.0, len(edges))
    st = _assert_matches(edges, n, dict(prune=False, engine="stress"),
                         weights=w)
    assert st.level_sizes[0] == (n, len(edges))


# -- the CLI -----------------------------------------------------------------------

def _run(main, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rep = main(argv)
    return rep, buf.getvalue().splitlines()


@pytest.mark.parametrize("argv", [
    ["--graph", "grid", "--args", "8", "8", "--engine", "stress"],
    ["--graph", "tree", "--args", "3", "3", "--engine", "flat", "--seed", "2"],
    ["--graph", "flower", "--args", "4", "5", "--driver", "centralized",
     "--no-cre"],
], ids=["grid_stress", "tree_flat", "flower_centralized"])
def test_cli_main_matches_jax(tmp_path, argv):
    rj, lj = _run(jax_cli.main, argv + ["--svg", str(tmp_path / "j.svg")])
    rt, lt = _run(cli.main, argv + ["--svg", str(tmp_path / "t.svg"),
                                    "--device", "cpu"])
    assert lt[0] == lj[0]                                  # graph line
    assert lt[1].split(" time=")[0] == lj[1].split(" time=")[0]
    assert lt[-1] == f"wrote {tmp_path / 't.svg'}"
    assert (tmp_path / "t.svg").read_text().startswith("<svg")
    assert (rt["n"], rt["m"]) == (rj["n"], rj["m"])
    assert abs(rt["neld"] - rj["neld"]) <= NELD_DELTA, (rt, rj)
    if "--no-cre" in argv:
        assert np.isnan(rt["cre"]) and np.isnan(rj["cre"])
    else:
        assert abs(rt["cre"] - rj["cre"]) <= CRE_DELTA, (rt, rj)


def test_engines_drivers_and_cli_default_to_the_card():
    """Without ``device=`` (or ``--device``) the layout runs on the card,
    so with no card it raises instead of moving to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    edges, n = G.grid(6, 6)
    w = np.ones(len(edges), np.float32)
    for cfg in (LayoutConfig(engine="stress"), LayoutConfig(driver="flat"),
                LayoutConfig(driver="centralized")):
        with pytest.raises(RuntimeError, match="cuda"):
            multigila_layout(edges, n, cfg, weights=w)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--graph", "grid", "--args", "6", "6", "--engine",
                  "stress"])
