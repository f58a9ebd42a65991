"""Port parity of the sharded path (``repro_torch.core.distributed``,
``core/partition.py``, ``launch/mesh.py`` and the near-field kernel's plain
version) against the live JAX package on the CPU.

The JAX side runs in one subprocess with 8 host devices
(``--xla_force_host_platform_device_count=8``, as ``test_distributed.py``
runs it), the port's in one spawn of 8 gloo ranks
(``tests/torch_dist_ranks.py``, meeting through a ``FileStore``); both start
together, compute every sharded case from one set of inputs made here from
numpy seeds, and leave their results in npz files that the tests below read.

Tolerance of float outputs: max |Δ| within 1e-4 of max |reference| (the
JAX tests' own bound); forces summed over other partitions and in other
orders differ in the last bits. Integer outputs (push_max, partitions,
hierarchies) must be equal. Layouts end to end: NELD within 0.05 and CRE
within 0.15 of JAX's, the deltas of ``test_torch_layout.py``.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import jax.numpy as jnp

from repro.core import distributed as JD
from repro.core import multigila_layout as jax_layout
from repro.core.gila import khop_neighbors, random_init
from repro.core.multilevel import LayoutConfig as JaxConfig
from repro.core.partition import edge_cut as jax_edge_cut
from repro.core.partition import partition_order as jax_order
from repro.core.partition import spinner_partition as jax_spinner
from repro.graphs import generators as G
from repro.graphs.graph import build_graph as jax_build_graph
from repro.graphs.metrics import cre, neld, sampled_stress
from repro.kernels.grid_force import ops as jops
from repro_torch.core import LayoutConfig, multigila_layout
from repro_torch.core import distributed as D
from repro_torch.core.partition import (edge_cut, partition_order,
                                        spinner_partition)
from repro_torch.graphs.graph import build_graph
from repro_torch.kernels import _build
from repro_torch.kernels.grid_force import ops as gops
from repro_torch.launch import mesh as mesh_mod

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REL_TOL = 1e-4
NELD_DELTA, CRE_DELTA = 0.05, 0.15

# the JAX side of every sharded case, on 8 host devices
JAX_CASES = """
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_compat_mesh
from repro.core import distributed as D
from repro.core import multigila_layout, LayoutConfig
from repro.launch import layout as cli
inp = dict(np.load(INP))
out = {}
m42 = make_compat_mesh((4, 2), ("data", "model"))
m81 = make_compat_mesh((8, 1), ("data", "model"))
m222 = make_compat_mesh((2, 2, 2), ("pod", "data", "model"))
a = jnp.asarray
params = a([1.0, 1.0, 1e-3], jnp.float32)
pos, w = a(inp["nb_pos"]), a(inp["nb_w"])
out["nbody"] = D.sharded_nbody(m42, 256)(pos, w, params)
src, dl, em, ew, m_pad = D.partition_edges(
    inp["at_src"], inp["at_dst"], inp["at_emask"], inp["at_ewt"], 256, 4)
out["attraction"] = D.sharded_attraction(m42, 256, m_pad)(
    pos, a(src), a(dl), a(em), a(ew), params)
out["push_max"] = D.sharded_push_max(m42, 256)(a(inp["pm_vals"]), a(src),
                                               a(dl), a(em))
out["neighbor"] = D.sharded_neighbor_force(m42, 256, 8)(
    pos, w, a(inp["nf_nbr"]), params)
gp = a([1.2, 0.9, 1e-2], jnp.float32)
G, cap = (int(x) for x in inp["grid_gc"])
for name in ("uniform", "overflow"):
    out["grid_" + name] = D.sharded_grid_force(m42, 512, G, cap)(
        a(inp["grid_%s_pos" % name]), a(inp["grid_%s_w" % name]), gp)
fn = D.sharded_grid_force(m42, 512, 8, 16, variant="halo")
for name in ("band", "violation"):
    out["halo_" + name] = fn(a(inp[name + "_pos"]), a(inp["band_w"]), gp)
for mname, mesh in (("4x2", m42), ("8x1", m81)):
    vs = 4 if mname == "4x2" else 8
    src, dl, em, ew, m_pad = D.partition_edges(
        inp["st_src"], inp["st_dst"], inp["st_emask"], inp["st_ewt"], 512, vs)
    for mode in ("exact", "neighbor", "grid"):
        nbr = (inp["st_nbr"] if mode == "neighbor"
               else np.full((512, 1), 512, np.int32))
        g, c = (G, cap) if mode == "grid" else (0, 0)
        for engine in ("gila", "stress"):
            step, _ = D.layout_train_step(mesh, 512, m_pad, nbr.shape[1],
                                          mode=mode, grid_dim=g, cell_cap=c,
                                          engine=engine)
            args = [a(inp["st_pos"]), a(inp["st_w"]), a(nbr), a(src), a(dl),
                    a(em), a(ew), gp, a(0.5, jnp.float32)]
            if engine == "stress":
                args.append(a(0.3, jnp.float32))
            out["step_%s_%s_%s" % (mname, engine, mode)] = \\
                jax.jit(step)(*args)
none = (a(np.full(8, 64, np.int32)), a(np.zeros(8, np.int32)),
        a(np.zeros(8, bool)), a(np.ones(8, np.float32)))
step, _ = D.layout_train_step_halo(m42, 64, 8, 8, 16)
out["halo_step"] = jax.jit(step)(
    a(inp["hs_pos"]), a(np.ones(64, np.float32)), a(inp["hs_local"]),
    a(inp["hs_send"]), *none, a([1.0, 1.0, 1e-2], jnp.float32),
    a(0.5, jnp.float32))
step, _ = D.layout_train_step_halo(m222, 64, 8, 8, 16)
out["halo_step_pod"] = jax.jit(step)(
    a(inp["hs_pos"]), a(np.ones(64, np.float32)), a(inp["hs_local"]),
    a(inp["hs_send"]), *none, a([1.0, 1.0, 1e-2], jnp.float32),
    a(0.5, jnp.float32))
step, _ = D.layout_train_step_halo(m42, 512, 8, 1, 1, mode="grid",
                                   grid_dim=8, cell_cap=16)
out["halo_step_grid"] = jax.jit(step)(
    a(inp["band_pos"]), a(inp["band_w"]),
    a(np.full((512, 1), 512, np.int32)), a(np.full((16, 1), 128, np.int32)),
    *none, gp, a(0.5, jnp.float32))
for tag, shape, kw in (("ml", (4, 2), {}),
                       ("ml3", (8, 1), dict(exact_threshold=64,
                                            grid_threshold=512))):
    edges, n = inp[tag + "_edges"], int(inp[tag + "_n"])
    for engine in ("gila", "stress"):
        p, st, exp = multigila_layout(edges, n, LayoutConfig(
            seed=0, driver="multigila_dist", engine=engine,
            mesh_shape=shape, **kw), export=True)
        out["%s_%s_pos" % (tag, engine)] = p
        for i, lvl in enumerate(exp.levels):
            out["%s_%s_exp%d_edges" % (tag, engine, i)] = lvl.edges
            out["%s_%s_exp%d_rep" % (tag, engine, i)] = lvl.rep
            if lvl.parent is not None:
                out["%s_%s_exp%d_parent" % (tag, engine, i)] = lvl.parent
rep = cli.main(["--graph", "grid", "--args", "12", "12", "--driver",
                "multigila_dist", "--no-cre", "--mesh", "4x2"])
out["cli_neld"] = np.asarray(rep["neld"])
np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
"""


def _inputs() -> dict:
    """Every case's inputs, from numpy seeds."""
    inp = {}
    rng = np.random.default_rng(0)
    e, n = G.grid(12, 12)
    g = jax_build_graph(e, n, n_pad=256)
    inp["nb_pos"] = rng.random((256, 2)).astype(np.float32)
    inp["nb_w"] = np.where(np.asarray(g.vmask), np.asarray(g.mass),
                           0).astype(np.float32)
    e, n = G.delaunay(200, seed=1)
    g = jax_build_graph(e, n, n_pad=256, ewt=rng.uniform(
        0.5, 2, len(e)).astype(np.float32))
    for k in ("src", "dst", "emask", "ewt"):
        inp["at_" + k] = np.asarray(getattr(g, k))
    inp["pm_vals"] = rng.integers(-1, 100, 256).astype(np.int32)
    inp["nf_nbr"] = rng.integers(0, 257, (256, 8)).astype(np.int32)
    # the grid inputs of test_distributed.py: uniform with masked padding,
    # and a cluster that overflows its cell's bucket cap
    rng = np.random.default_rng(0)
    uni = (rng.random((512, 2)) * 10).astype(np.float32)
    vmask = rng.random(512) > 0.1
    inp["grid_uniform_pos"] = np.where(vmask[:, None], uni, 0).astype(
        np.float32)
    inp["grid_uniform_w"] = np.where(vmask, rng.random(512) + 0.5,
                                     0).astype(np.float32)
    inp["grid_overflow_pos"] = np.concatenate(
        [rng.normal(0, 0.05, (200, 2)),
         rng.random((312, 2)) * 8]).astype(np.float32)
    inp["grid_overflow_w"] = (rng.random(512) + 0.5).astype(np.float32)
    inp["grid_gc"] = np.asarray(jops.choose_grid(512))
    # the band partition of the halo variant: block d in grid rows
    # [2d, 2d + 2) of a [0, 10)² box, one overflowing cell in block 1
    rng = np.random.default_rng(1)
    pos = np.zeros((512, 2), np.float32)
    for d in range(4):
        ylo, yhi = d * 2.5 + 0.05, (d + 1) * 2.5 - 0.05
        blk = rng.random((128, 2)).astype(np.float32)
        pos[d * 128:(d + 1) * 128, 0] = blk[:, 0] * 10
        pos[d * 128:(d + 1) * 128, 1] = ylo + blk[:, 1] * (yhi - ylo)
    pos[0] = (0.0, 0.0)
    pos[-1] = (10.0, 10.0)
    pos[128:168] = (5.2, 3.1) + rng.normal(0, 0.02, (40, 2)).astype(
        np.float32)
    inp["band_w"] = (rng.random(512) + 0.5).astype(np.float32)
    inp["band_pos"] = pos.copy()
    pos[5] = (5.0, 9.0)                  # stored on rank 0, sits in band 3
    inp["violation_pos"] = pos
    # one full step: a real graph with weights, k-hop lists of cap 16
    rng = np.random.default_rng(3)
    e, n = G.delaunay(400, seed=2)
    g = jax_build_graph(e, n, n_pad=512, ewt=rng.uniform(
        0.5, 2, len(e)).astype(np.float32))
    for k in ("src", "dst", "emask", "ewt"):
        inp["st_" + k] = np.asarray(getattr(g, k))
    inp["st_pos"] = np.where(np.asarray(g.vmask)[:, None],
                             rng.random((512, 2)) * 10, 0).astype(np.float32)
    inp["st_w"] = np.where(np.asarray(g.vmask), rng.random(512) + 0.5,
                           0).astype(np.float32)
    idx, mask = khop_neighbors(e, n, 2, 16, seed=4)
    nbr = np.full((512, 16), 512, np.int32)
    nbr[:n] = np.where(mask, idx, 512)
    inp["st_nbr"] = nbr
    # the halo step of test_distributed.py: 4 vertex ranks of 16, each
    # vertex with 8 random partners, a full halo (every peer sends all)
    rng = np.random.default_rng(0)
    inp["hs_pos"] = rng.random((64, 2)).astype(np.float32)
    nbr = rng.integers(0, 64, (64, 8)).astype(np.int32)
    inp["hs_nbr"] = nbr
    owner, local = nbr // 16, nbr % 16
    me = (np.arange(64) // 16)[:, None]
    inp["hs_local"] = np.where(owner == me, local,
                               16 + owner * 16 + local).astype(np.int32)
    inp["hs_send"] = np.tile(np.arange(16, dtype=np.int32), (16, 1))
    edges, n = G.grid(18, 18)
    inp["ml_edges"], inp["ml_n"] = edges, np.asarray(n)
    edges, n = G.delaunay(1500, seed=4)
    inp["ml3_edges"], inp["ml3_n"] = edges, np.asarray(n)
    return inp


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX results, port results, rank-1 note): both sides run at
    once, in their own processes."""
    d = tmp_path_factory.mktemp("dist")
    inp = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = f"INP, OUT = {str(d / 'inputs.npz')!r}, {str(d / 'jax.npz')!r}\n"
    jax_p = subprocess.Popen([sys.executable, "-c",
                              code + textwrap.dedent(JAX_CASES)],
                             env=jenv, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    tenv = dict(env, OMP_NUM_THREADS="1")
    torch_p = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_dist_ranks.py"),
         str(d / "inputs.npz"), str(d)], env=tenv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    outs = {}
    for name, p in (("jax", jax_p), ("torch", torch_p)):
        so, se = p.communicate(timeout=900)
        assert p.returncode == 0, f"{name}:\n{se[-6000:]}"
        outs[name] = dict(np.load(d / f"{name}.npz"))
    note = (d / "rank1.txt").read_text()
    return inp, outs["jax"], outs["torch"], note


def _close(got, ref, tol=REL_TOL):
    err = float(np.abs(np.asarray(got) - np.asarray(ref)).max())
    scale = float(np.abs(np.asarray(ref)).max())
    assert err <= tol * scale, (err, scale)


def test_every_rank_returns_the_same_results(runs):
    """Each case's output is gathered on every rank: rank 1's equal rank
    0's, and rank 1 printed nothing of the CLI."""
    _, _, got, note = runs
    same, total, printed = note.split(" ", 2)
    assert same == total, note
    assert printed == "printed=''"


@pytest.mark.parametrize("case", ["nbody", "attraction", "neighbor"])
def test_sharded_building_blocks_match_jax(runs, case):
    _, ref, got, _ = runs
    _close(got[case], ref[case])


def test_sharded_push_max_equals_jax(runs):
    _, ref, got, _ = runs
    np.testing.assert_array_equal(got["push_max"], ref["push_max"])


@pytest.mark.parametrize("name", ["uniform", "overflow"])
def test_sharded_grid_force_matches_jax_and_single_device(runs, name):
    """The all-gather variant against JAX's and against the port's own
    single-device ``grid_repulsion`` (masked to the valid vertices)."""
    inp, ref, got, _ = runs
    _close(got[f"grid_{name}"], ref[f"grid_{name}"])
    pos = torch.from_numpy(inp[f"grid_{name}_pos"])
    w = torch.from_numpy(inp[f"grid_{name}_w"])
    G_, cap = (int(x) for x in inp["grid_gc"])
    single = gops.grid_repulsion(pos, w, w > 0,
                                 _build.consts_tensor(1.2, 0.9, 1e-2, "cpu"),
                                 grid_dim=G_, cell_cap=cap)
    single = torch.where((w > 0)[:, None], single, 0.0).numpy()
    _close(got[f"grid_{name}"], single)
    if name == "overflow":
        _, _, inb = gops.bin_vertices(pos, w > 0, G_, cap)
        assert int((~inb).sum()) > 50                 # caps overflowed


def test_sharded_grid_force_halo_under_band_partition(runs):
    """The halo variant: within tolerance of JAX's and of the single-device
    op under the band contract; with one vertex violating it, every other
    vertex stays within 5% of the single-device op, as JAX's test holds."""
    inp, ref, got, _ = runs
    _close(got["halo_band"], ref["halo_band"])
    _close(got["halo_violation"], ref["halo_violation"])
    consts = _build.consts_tensor(1.2, 0.9, 1e-2, "cpu")
    w = torch.from_numpy(inp["band_w"])
    single = gops.grid_repulsion(torch.from_numpy(inp["band_pos"]), w,
                                 w > 0, consts, grid_dim=8,
                                 cell_cap=16).numpy()
    _close(got["halo_band"], single)
    viol = gops.grid_repulsion(torch.from_numpy(inp["violation_pos"]), w,
                               w > 0, consts, grid_dim=8,
                               cell_cap=16).numpy()
    others = np.delete(np.arange(512), 5)
    assert np.isfinite(got["halo_violation"]).all()
    assert (np.abs(got["halo_violation"][others] - viol[others]).max()
            < 0.05 * np.abs(viol).max())


@pytest.mark.parametrize("mesh", ["4x2", "8x1"])
@pytest.mark.parametrize("engine", ["gila", "stress"])
@pytest.mark.parametrize("mode", ["exact", "neighbor", "grid"])
def test_layout_train_step_matches_jax(runs, mesh, engine, mode):
    _, ref, got, _ = runs
    key = f"step_{mesh}_{engine}_{mode}"
    _close(got[key], ref[key])


@pytest.mark.parametrize("mesh", ["4x2", "pod 2x2x2"])
def test_layout_train_step_halo_matches_allgather_step_and_jax(runs, mesh):
    """A full halo reproduces the all-gather step; the halo step equals
    JAX's in neighbor mode, and (4x2) in grid mode. On the pod mesh the
    vertex axes are (pod, data) and the all-to-all runs a stage an axis."""
    _, ref, got, _ = runs
    sfx = "" if mesh == "4x2" else "_pod"
    _close(got["halo_step" + sfx], got["halo_step_ag" + sfx])
    _close(got["halo_step" + sfx], ref["halo_step" + sfx])
    if mesh == "4x2":
        _close(got["halo_step_grid"], ref["halo_step_grid"])


@pytest.mark.parametrize("engine", ["gila", "stress"])
@pytest.mark.parametrize("tag", ["ml", "ml3"])
def test_multigila_dist_end_to_end_matches_jax(runs, engine, tag):
    """``driver="multigila_dist"``: grid(18, 18) at mesh 4x2 (``ml``), and
    delaunay(1500) with exact_threshold=64, grid_threshold=512 — all three
    modes — at mesh 8x1 (``ml3``). The hierarchy (its export, level by
    level) equal to JAX's, NELD and CRE within the deltas of JAX's run, and
    on the grid the layout untangles the graph (sampled stress below half
    the random init's, as JAX's test holds)."""
    inp, ref, got, _ = runs
    edges, n = inp[f"{tag}_edges"], int(inp[f"{tag}_n"])
    keys = [k for k in ref if k.startswith(f"{tag}_{engine}_exp")]
    assert keys and sorted(keys) == sorted(
        k for k in got if k.startswith(f"{tag}_{engine}_exp"))
    for k in keys:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    if tag == "ml3":
        assert set(got[f"{tag}_{engine}_modes"]) == {"exact", "neighbor",
                                                      "grid"}
    p, pj = got[f"{tag}_{engine}_pos"], ref[f"{tag}_{engine}_pos"]
    assert np.isfinite(p).all()
    assert abs(neld(p, edges) - neld(pj, edges)) <= NELD_DELTA
    assert abs(cre(p, edges) - cre(pj, edges)) <= CRE_DELTA
    if tag == "ml":
        p0 = np.asarray(random_init(jax_build_graph(edges, n), 6.0, 0))[:n]
        assert (sampled_stress(p, edges, n)
                < 0.5 * sampled_stress(p0, edges, n))


def test_cli_mesh_on_gloo_ranks(runs):
    """``--driver multigila_dist --mesh 4x2`` on 8 ranks: rank 0 prints the
    report, NELD within the delta of JAX's CLI; ``--mesh 2x2`` on 8 ranks
    is a ValueError on every rank."""
    _, ref, got, _ = runs
    text = got["cli_text"].item()
    assert "levels=" in text and "NELD=" in text, text
    assert abs(float(got["cli_neld"]) - float(ref["cli_neld"])) <= NELD_DELTA
    assert got["cli_mismatch"].item().startswith("ValueError"), \
        got["cli_mismatch"]


# -- in one process -------------------------------------------------------------

@pytest.mark.parametrize("multiple_of", [1, 4, 8, 16])
def test_choose_grid_multiple_of_equals_jax(multiple_of):
    """``choose_grid(n, multiple_of=)``, the halo variant's band rounding,
    equal to JAX's at sizes from a few cells to the 128 cap."""
    for n in (10, 500, 5000, 77777, 10 ** 6):
        assert gops.choose_grid(n, multiple_of=multiple_of) == \
            jops.choose_grid(n, multiple_of=multiple_of)


def test_partition_edges_equals_jax():
    rng = np.random.default_rng(5)
    e, n = G.delaunay(300, seed=5)
    g = jax_build_graph(e, n, n_pad=512, ewt=rng.uniform(
        0.5, 2, len(e)).astype(np.float32))
    arrs = [np.asarray(getattr(g, k)) for k in ("src", "dst", "emask",
                                                "ewt")]
    for vsize in (1, 4, 8):
        for bucket in (False, True):
            a = JD.partition_edges(*arrs, 512, vsize, bucket=bucket)
            b = D.partition_edges(*arrs, 512, vsize, bucket=bucket)
            assert a[4] == b[4]
            for x, y in zip(a[:4], b[:4]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("P,slack,seed,iters", [
    (4, 1.10, 0, 48), (4, 1.03, 5, 48), (8, 1.05, 2, 48), (3, 1.10, 7, 5)])
def test_spinner_partition_equals_jax(P, slack, seed, iters):
    """Labels bit-equal to JAX's (the coin flips are JAX's threefry bits);
    edge_cut and partition_order equal; the max load within
    floor(slack · n / P), as ``test_spinner_partition_respects_slack_
    capacity`` holds JAX's."""
    e, n = G.grid(24, 24)
    perm = np.random.default_rng(0).permutation(n)
    gj = jax_build_graph(perm[e], n)
    gt = build_graph(perm[e], n, device="cpu")
    want = np.asarray(jax_spinner(gj, P, iters=iters, slack=slack,
                                  seed=seed))
    got = spinner_partition(gt, P, iters=iters, slack=slack, seed=seed)
    np.testing.assert_array_equal(got, want)
    assert edge_cut(gt, got) == jax_edge_cut(gj, want)
    np.testing.assert_array_equal(partition_order(got, gt.vmask),
                                  np.asarray(jax_order(want, gj.vmask)))
    loads = np.bincount(got[: n], minlength=P)
    assert loads.max() <= np.floor(slack * n / P)
    if iters == 48 and P == 4 and slack == 1.10:
        blocked = np.minimum(np.arange(gt.n_pad) * 4 // n, 3)
        assert edge_cut(gt, got) < edge_cut(gt, blocked) * 0.8


@pytest.mark.parametrize("form", ["index", "direct"])
@pytest.mark.parametrize("split", [(0, None), (0, 40), (40, 60), (100, 20)])
def test_near_field_plain_matches_jax(form, split):
    """The near field a row at a time on the sharded step's inputs: the
    port's plain version against the JAX package's ``near_field`` (its ref
    and its Pallas kernel in interpret mode) on the partner lists gathered
    as ``_grid_rep_spmd`` gathers them, for a column chunk of the 9·cap
    slots (columns past 9·cap add 0)."""
    rng = np.random.default_rng(8)
    R, N, ncell, cap = 37, 90, 20, 7                 # K = 63
    col0, ncols = split
    K = 9 * cap
    kc = K - col0 if ncols is None else ncols
    rows = rng.random((R, 2)).astype(np.float32) * 4
    near9 = rng.integers(0, ncell, (R, 9)).astype(np.int32)
    near9[rng.random((R, 9)) < 0.2] = ncell - 1     # the empty sentinel row
    pos = (rng.random((N + 1, 2)) * 4).astype(np.float32)
    w = (rng.random(N + 1) + 0.5).astype(np.float32)
    pos[N], w[N] = 0, 0
    slots = rng.integers(0, N + 1, (ncell, cap)).astype(np.int32)
    slots[ncell - 1] = N
    xyw = np.concatenate([pos[slots], w[slots][..., None]], -1)
    if form == "index":
        nbr_pos, nbr_w = pos[slots[near9].reshape(R, K)], \
            w[slots[near9].reshape(R, K)]
        kw = dict(pos=torch.from_numpy(pos), w=torch.from_numpy(w))
        cells = torch.from_numpy(slots)
    else:
        e = xyw[near9].reshape(R, K, 3)
        nbr_pos, nbr_w = e[..., :2], e[..., 2]
        kw = {}
        cells = torch.from_numpy(xyw.astype(np.float32))
    pad = max(0, col0 + kc - K)
    nbr_pos = np.pad(nbr_pos, ((0, 0), (0, pad), (0, 0)))[:, col0:col0 + kc]
    nbr_w = np.pad(nbr_w, ((0, 0), (0, pad)))[:, col0:col0 + kc]
    consts = _build.consts_tensor(1.3, 0.8, 1e-2, "cpu")
    got = gops.near_field(torch.from_numpy(rows), torch.from_numpy(near9),
                          cells, consts, col0=col0, ncols=kc, **kw).numpy()
    for backend in ("ref", "interpret"):
        want = np.asarray(jops.near_field(
            jnp.asarray(rows)[:, None, :], jnp.asarray(nbr_pos),
            jnp.asarray(nbr_w), 1.3, 0.8, 1e-2, backend=backend))[:, 0]
        _close(got, want)


def test_mesh_none_in_one_rank_process():
    """``mesh_shape=None`` with no process group: the driver makes a one-rank
    gloo group over a FileStore (and ``shutdown`` takes it down), and its
    layout matches JAX's one-device mesh; a 2x2 mesh in a one-rank world is
    a ValueError; a CUDA mesh without a card raises."""
    import torch.distributed as dist
    edges, n = G.grid(10, 10)
    assert not dist.is_initialized()
    try:
        p, st = multigila_layout(edges, n, LayoutConfig(
            driver="multigila_dist", seed=0), device="cpu")
        assert dist.is_initialized() and dist.get_world_size() == 1
        with pytest.raises(ValueError, match="ranks"):
            mesh_mod.make_mesh((2, 2), device="cpu")
    finally:
        mesh_mod.shutdown()
    assert not dist.is_initialized()
    pj, sj = jax_layout(edges, n, JaxConfig(driver="multigila_dist", seed=0))
    assert st.levels == sj.levels
    assert abs(neld(p, edges) - neld(pj, edges)) <= NELD_DELTA
    assert abs(cre(p, edges) - cre(pj, edges)) <= CRE_DELTA
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mesh_mod.make_host_mesh(device="cuda")
