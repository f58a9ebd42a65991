"""Port parity: threefry randomness, graph containers, import hygiene and the
default device, against the live JAX package on the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.graphs import generators as G
from repro.graphs.graph import build_graph as jax_build_graph
from repro.utils import prng as jax_prng
from repro_torch.graphs.graph import (build_graph, bucket_pad, push_max,
                                      unique_edges)
from repro_torch.utils import prng

SRC = Path(__file__).resolve().parents[1] / "src"


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_key_fold_in_and_split_chain_equal_jax(seed):
    key = jax.random.PRNGKey(seed)
    assert tuple(int(x) for x in np.asarray(key)) == prng.prng_key(seed)
    for d in (0, 1, 999, 2**31 - 1):
        assert (tuple(int(x) for x in np.asarray(jax.random.fold_in(key, d)))
                == prng.fold_in(prng.prng_key(seed), d))
    jk, tk = key, prng.prng_key(seed)
    for _ in range(96):                 # the merger's per-round key stream
        jk, jsub = jax.random.split(jk)
        tk, tsub = prng.split(tk)
        assert tuple(int(x) for x in np.asarray(jsub)) == tsub
    assert tuple(int(x) for x in np.asarray(jk)) == tk


@pytest.mark.parametrize("lo,hi", [(0.0, 1.0), (0.0, 2 * np.pi),
                                   (-37.5, 37.5), (-3.7, 3.7)])
def test_uniform_per_vertex_bit_identical(lo, hi):
    ids = np.arange(5000, dtype=np.int32)
    key = jax.random.PRNGKey(3)
    a = np.asarray(jax_prng.uniform_per_vertex(key, jnp.asarray(ids), lo, hi))
    b = prng.uniform_per_vertex(prng.prng_key(3), torch.from_numpy(ids),
                                lo, hi).numpy()
    np.testing.assert_array_equal(a, b)
    a2 = np.asarray(jax_prng.uniform2_per_vertex(key, jnp.asarray(ids),
                                                 lo, hi))
    b2 = prng.uniform2_per_vertex(prng.prng_key(3), torch.from_numpy(ids),
                                  lo, hi).numpy()
    np.testing.assert_array_equal(a2, b2)


@pytest.mark.parametrize("bucket", [False, True])
def test_build_graph_arrays_equal(bucket):
    edges, n = G.delaunay(700, seed=2)
    rng = np.random.default_rng(0)
    mass = rng.integers(1, 4, n).astype(np.float32)
    ewt = rng.random(len(edges)).astype(np.float32) + 0.5
    gj = jax_build_graph(edges, n, mass=mass, ewt=ewt, bucket=bucket)
    gt = build_graph(edges, n, mass=mass, ewt=ewt, bucket=bucket,
                     device="cpu")
    assert (gt.n, gt.m, gt.n_pad, gt.m_pad) == (gj.n, gj.m, gj.n_pad,
                                                gj.m_pad)
    for f in ("src", "dst", "vmask", "emask", "mass", "ewt"):
        a, b = np.asarray(getattr(gj, f)), getattr(gt, f).numpy()
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)
    np.testing.assert_array_equal(unique_edges(gt), edges)
    assert bucket_pad(700) == 1024 and bucket_pad(3) == 256


def test_push_max_matches_jax():
    from repro.core.solar_merger import _push_max as jax_push_max
    edges, n = G.grid(9, 7)
    gj = jax_build_graph(edges, n, bucket=True)
    gt = build_graph(edges, n, bucket=True, device="cpu")
    vals = np.random.default_rng(1).integers(-1, n, gt.n_pad).astype(np.int32)
    a = np.asarray(jax_push_max(gj, jnp.asarray(vals)))
    b = push_max(gt, torch.from_numpy(vals)).numpy()
    np.testing.assert_array_equal(a, b)


def test_import_hygiene_no_jax_no_repro():
    """Every repro_torch module imports without JAX or the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,"
        " 'repro_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "assert len(mods) >= 20, mods\n"
        "new = {'repro_torch.core.distributed', 'repro_torch.core.partition',"
        " 'repro_torch.launch.mesh'}\n"
        "assert new <= set(mods), new - set(mods)\n"
        "print(len(mods))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120,
                         env=dict(os.environ,
                                  PYTHONPATH=f"{SRC}{os.pathsep}{SRC.parent}"))
    assert out.returncode == 0, out.stderr
    # chip_smoke.py imports inside main(): no import of either, anywhere
    tree = ast.parse((SRC.parent / "chip_smoke.py").read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert names and not [m for m in names if m.split(".")[0] in ("jax",
                                                                  "repro")]


def test_default_device_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    from repro_torch.core import multigila_layout
    edges, n = G.grid(6, 6)
    with pytest.raises(RuntimeError, match="cuda"):
        multigila_layout(edges, n)
    with pytest.raises(RuntimeError, match="cuda"):
        build_graph(edges, n)


def test_generators_pruning_and_metrics_match_jax():
    """The port's numpy copies: same graphs, same pruning and reinsertion,
    same quality scores on the same drawing."""
    from repro.core.pruning import prune_degree_one as jax_prune
    from repro.core.pruning import reinsert as jax_reinsert
    from repro.graphs import metrics as jax_metrics
    from repro_torch.core.pruning import prune_degree_one, reinsert
    from repro_torch.graphs import generators, metrics

    ours = generators.regulargraphs_suite(small=True)
    for (na, ea, n_a), (nb, eb, n_b) in zip(G.regulargraphs_suite(small=True),
                                            ours):
        assert na == nb and n_a == n_b
        np.testing.assert_array_equal(ea, eb)
    edges, n = generators.with_degree_one_fringe(*generators.delaunay(
        400, seed=5), frac=0.3, seed=2)
    np.testing.assert_array_equal(edges, G.with_degree_one_fringe(
        *G.delaunay(400, seed=5), frac=0.3, seed=2)[0])
    pj, pt = jax_prune(edges, n), prune_degree_one(edges, n)
    for f in ("edges", "mass", "old_of_new", "leaves", "leaf_host"):
        np.testing.assert_array_equal(getattr(pj, f), getattr(pt, f))
    kept = np.random.default_rng(0).random((pt.n, 2)).astype(np.float32) * 20
    pos = reinsert(pt, kept, pt.edges)
    np.testing.assert_allclose(pos, jax_reinsert(pj, kept, pj.edges),
                               rtol=0, atol=1e-5)
    gj = jax_build_graph(edges, n)
    qj = jax_metrics.quality_report(gj, pos)
    qt = metrics.quality_report(build_graph(edges, n, device="cpu"), pos)
    assert qt["n"] == qj["n"] and qt["m"] == qj["m"]
    assert qt["cre"] == qj["cre"]
    for k in ("neld", "stress"):
        assert qt[k] == pytest.approx(qj[k], rel=1e-6)
