"""The port's dry-run ``layout`` and ``pp`` suites (``repro_torch.launch.
dryrun``) and what they read, against the live JAX package on the CPU.

In process: ``configs/multigila.py``'s presets equal the JAX package's
(names, generators and arguments, ``BIG_GRAPH_DRYRUN`` entry for entry,
``LayoutConfig()`` field for field); the meta routes of ``grid_far`` and
``near_field`` (both forms) give the shapes and dtypes of their CPU route
on the same inputs and count 11 FLOPs a pair.

Over fake process groups, in one subprocess beside one that runs JAX on 8
host devices (both at once, as ``test_torch_dryrun.py``'s fixture runs
them): at meshes (4, 2) and (2, 2, 2) the blocks of ``layout_step_specs``
(every mode, both engines) and ``layout_halo_specs`` (both modes) equal
JAX's ``NamedSharding.shard_shape`` and dtype of every input under the
shardings that its ``layout_train_step`` / ``layout_train_step_halo``
return; the layout suite at small sizes (SMALL, the coarse threshold
lowered to EXACT_MAX_N) runs every row to its end on meta, its argument
bytes equal JAX's shards', and its counted collectives equal the table
that COLLECTIVES writes from the step's code, the all-gather step's
all-gather bytes the ring model's; ``comm.ppermute`` and ``_halo_rows`` on
meta return meta tensors of the right shapes and count their
collective-permute bytes; the pp suite at smoke scale (gemma-2b's smoke
config in 2 stages on a fake (2, 2, 2) mesh, forward and gradient; ring
attention on a fake (2, 4) mesh) counts its permutes over "pod" and over
"model" as the schedules give them.
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs import multigila_presets as jax_presets
from repro_torch.configs import multigila_presets as presets
from repro_torch.kernels.grid_force import ops as gops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESHES = [("4x2", (4, 2), ("data", "model")),
          ("2x2x2", (2, 2, 2), ("pod", "data", "model"))]
N, M, CAP = 1 << 14, 1 << 16, 8
SMALL = dict(fine=dict(n_pad=N, m_pad=M, cap=CAP),
             coarse=dict(n_pad=1 << 12, m_pad=1 << 14, cap=CAP))
EXACT_MAX_N = 1 << 13
ROWS = [("fine", m) for m in ("neighbor", "halo", "grid", "grid_halo")] + \
    [("coarse", m) for m in ("neighbor", "exact")]
STEP_CASES = [(mode, engine) for mode in ("neighbor", "exact", "grid")
              for engine in ("gila", "stress")]
HALO_MODES = ("neighbor", "grid")
PP_SMOKE = dict(arch="gemma-2b", batch=8, seq=32, microbatches=2)
RING_SMOKE = dict(B=4, S=64, H=4, KV=2, hd=16)


def _halo(n_pad: int, vsize: int) -> int:
    return max(n_pad // vsize // 8, 128)


def _axis_sizes(shape, axes) -> dict:
    return dict(zip(axes, shape))


# -- presets ------------------------------------------------------------------

def test_presets_equal_jax():
    assert presets.REGULAR == jax_presets.REGULAR
    assert presets.BIG_GRAPH_DRYRUN == jax_presets.BIG_GRAPH_DRYRUN
    assert [(e.name, e.generator, e.args) for e in presets.REAL_GRAPHS] == \
        [(e.name, e.generator, e.args) for e in jax_presets.REAL_GRAPHS]
    assert [f.name for f in dataclasses.fields(presets.LayoutExperiment)] \
        == [f.name for f in dataclasses.fields(jax_presets.LayoutExperiment)]


@pytest.mark.parametrize("i", range(3))
def test_real_graph_configs_equal_jax(i):
    """Each experiment's generator exists in the port and its
    ``LayoutConfig()`` equals JAX's field for field."""
    from repro_torch.graphs import generators
    e, je = presets.REAL_GRAPHS[i], jax_presets.REAL_GRAPHS[i]
    assert callable(getattr(generators, e.generator))
    assert dataclasses.asdict(e.cfg) == dataclasses.asdict(je.cfg)


# -- the grid kernels' meta routes --------------------------------------------

def _near_inputs(form: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    R, ncell, cap, N_ = 50, 12, 4, 40
    rows = torch.from_numpy(rng.uniform(0, 1, (R, 2)).astype(np.float32))
    near9 = torch.from_numpy(rng.integers(0, ncell, (R, 9)).astype(np.int32))
    consts = torch.tensor([1.0, 1e-6])
    if form == "index":
        cells = torch.from_numpy(
            rng.integers(0, N_ + 1, (ncell, cap)).astype(np.int32))
        pos = torch.from_numpy(rng.uniform(0, 1, (N_ + 1, 2))
                               .astype(np.float32))
        w = torch.ones(N_ + 1)
        w[-1] = 0
        return rows, near9, cells, consts, dict(pos=pos, w=w)
    cells = torch.from_numpy(rng.uniform(0, 1, (ncell, cap, 3))
                             .astype(np.float32))
    return rows, near9, cells, consts, {}


def _meta(x):
    if isinstance(x, dict):
        return {k: _meta(v) for k, v in x.items()}
    return x.to("meta")


@pytest.mark.parametrize("lanes", [False, True])
def test_grid_far_meta_route(lanes, monkeypatch):
    rng = np.random.default_rng(1)
    B = (3,) if lanes else ()
    pos = torch.from_numpy(rng.uniform(0, 1, B + (30, 2)).astype(np.float32))
    cells = torch.from_numpy(rng.uniform(0, 1, B + (7, 3))
                             .astype(np.float32))
    consts = torch.tensor([[1.0, 1e-6]] * 3 if lanes else [1.0, 1e-6])
    want = gops.grid_far(pos, cells, consts)
    monkeypatch.setattr(gops, "meta_flops", [])
    monkeypatch.setattr(gops, "meta_bytes", [])
    got = gops.grid_far(pos.to("meta"), cells.to("meta"), consts.to("meta"))
    assert got.device.type == "meta"
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    assert gops.meta_flops == [11 * (3 if lanes else 1) * 30 * 7]
    assert gops.meta_bytes == [sum(t.numel() * t.element_size()
                                   for t in (want, pos, cells, consts))]


@pytest.mark.parametrize("form", ["index", "direct"])
@pytest.mark.parametrize("cols", [None, (18, 20), (36, 8)])
def test_near_field_meta_route(form, cols, monkeypatch):
    """Both forms, all the columns or a "model" rank's chunk (the second
    past 9·cap: no real column, no FLOP)."""
    rows, near9, cells, consts, kw = _near_inputs(form)
    col = {} if cols is None else dict(col0=cols[0], ncols=cols[1])
    want = gops.near_field(rows, near9, cells, consts, **kw, **col)
    monkeypatch.setattr(gops, "meta_flops", [])
    got = gops.near_field(_meta(rows), _meta(near9), _meta(cells),
                          _meta(consts), **_meta(kw), **col)
    assert got.device.type == "meta"
    assert (tuple(got.shape), got.dtype) == (tuple(want.shape), want.dtype)
    K = 9 * cells.shape[1]
    real = K if cols is None else max(min(sum(cols), K) - cols[0], 0)
    assert gops.meta_flops == [11 * rows.shape[0] * real]


def _bad_call(case: str):
    """A call the card's route refuses, on meta."""
    rows, near9, cells, consts, kw = _near_inputs(
        "direct" if case == "near_direct_cells" else "index")
    if case == "near_near9_int64":
        near9 = near9.long()
    elif case == "near_pos_width":
        kw["pos"] = torch.zeros(kw["pos"].shape[0], 3)
    elif case == "near_direct_cells":
        cells = cells.double()
    if case.startswith("near"):
        return lambda: gops.near_field(_meta(rows), _meta(near9),
                                       _meta(cells), _meta(consts),
                                       **_meta(kw))
    pos, cell_xyw = torch.zeros(30, 2), torch.zeros(7, 3)
    consts = torch.tensor([1.0, 1e-6])
    if case == "far_pos_width":
        pos = torch.zeros(30, 3)
    elif case == "far_cells_f64":
        cell_xyw = cell_xyw.double()
    return lambda: gops.grid_far(_meta(pos), _meta(cell_xyw), _meta(consts))


@pytest.mark.parametrize("case", ["near_near9_int64", "near_pos_width",
                                  "near_direct_cells", "far_pos_width",
                                  "far_cells_f64"])
def test_meta_route_refuses_what_the_card_refuses(case, monkeypatch):
    """The meta routes run the card route's checks of dtype and shape
    before they return, so a dry run refuses what the card would."""
    monkeypatch.setattr(gops, "meta_flops", [])
    with pytest.raises(ValueError, match="dtype|shape"):
        _bad_call(case)()
    assert gops.meta_flops == []


# -- over fake groups, beside JAX's shard shapes --------------------------------

PORT_RUN = """
import json, sys
sys.path.insert(0, SRC)
import torch
from repro_torch.configs import get_smoke_config
from repro_torch.core import distributed as DI
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_fake_mesh, shutdown
from repro_torch.parallel import comm

D.BIG_GRAPH_DRYRUN = SMALL
D.EXACT_MAX_N = EXACT_MAX_N


def shapes(specs):
    return {k: [list(v.shape), str(v.dtype).replace("torch.", "")]
            for k, v in specs.items()}


def counted(c):
    return {"%s:%d" % k: b for k, b in c.items()}


out = {"specs": {}, "rows": {}, "p2p": {}}
for name, shape, axes in MESHES:
    mesh = make_fake_mesh(shape, axes)
    for mode, engine in STEP_CASES:
        out["specs"]["%s:step:%s:%s" % (name, mode, engine)] = shapes(
            DI.layout_step_specs(mesh, N, M, CAP, mode=mode, engine=engine))
    for mode in HALO_MODES:
        out["specs"]["%s:halo:%s" % (name, mode)] = shapes(
            DI.layout_halo_specs(mesh, N, M, CAP, HALO[name], mode=mode))
    assert D.layout_rows() == [tuple(r) for r in ROWS], D.layout_rows()
    for gname, mode in D.layout_rows():
        out["rows"]["%s:%s:%s" % (name, gname, mode)] = D.run_layout_row(
            mesh, gname, mode)
    vs = mesh.vtx_size
    x = torch.empty(3, 5, device="meta")
    with comm.counting() as c:
        y = comm.ppermute(x, mesh.vtx_group, [(i, (i + 1) % vs)
                                              for i in range(vs)])
        z = comm.ppermute(x, mesh.vtx_group, [(1, 2)])
    out["p2p"][name + ":ppermute"] = dict(
        shapes=[list(t.shape) for t in (y, z)],
        devices=[t.device.type for t in (y, z)], counted=counted(c))
    band = torch.empty(2, 16, 8, 3, device="meta")
    with comm.counting() as c:
        top, bot = DI._halo_rows(mesh, band)
    out["p2p"][name + ":halo_rows"] = dict(
        shapes=[list(t.shape) for t in (top, bot)],
        devices=[t.device.type for t in (top, bot)], counted=counted(c))
mesh = make_fake_mesh((2, 2, 2), ("pod", "data", "model"))
out["pp"] = D.pp_record(mesh, get_smoke_config("gemma-2b"), PP_SMOKE)
mesh = make_fake_mesh((2, 4))
out["ring"] = D.ring_record(mesh, RING_SMOKE)
shutdown()
json.dump(out, open(OUT, "w"))
"""

JAX_SHARDS = """
import json
import numpy as np
from repro.core import distributed as JDI
from repro.kernels.grid_force.ops import choose_grid
from repro.launch.mesh import make_compat_mesh

STEP_KEYS = dict(pos="pos", w="w", nbr_idx="nbr_idx", src="edge",
                 dst_local="edge", emask="edge", ewt="edge", params="scalar",
                 temp="scalar", alpha="scalar")
HALO_KEYS = dict(pos="pos", w="w", nbr_local="nbr_idx", send_idx="send",
                 src_local="edge", dst_local="edge", emask="edge",
                 ewt="edge", params="scalar", temp="scalar")


def shard_shapes(specs, sh, keys):
    return {k: [list(sh[keys[k]].shard_shape(v.shape)),
                np.dtype(v.dtype).name] for k, v in specs.items()}


def step_shards(mesh, n, m, cap, mode, engine="gila"):
    G, cc = choose_grid(n)
    specs = JDI.layout_step_specs(n, m, cap, mode=mode, engine=engine)
    _, sh = JDI.layout_train_step(mesh, n, m, specs["nbr_idx"].shape[1],
                                  mode=mode, grid_dim=G, cell_cap=cc,
                                  engine=engine)
    return shard_shapes(specs, sh, STEP_KEYS)


def halo_shards(mesh, n, m, cap, halo, mode, vsize):
    G, cc = choose_grid(n, multiple_of=vsize)
    specs = JDI.layout_halo_specs(mesh, n, m, cap, halo, mode=mode)
    _, sh = JDI.layout_train_step_halo(mesh, n, m, specs["nbr_local"].shape[1],
                                       halo, mode=mode, grid_dim=G,
                                       cell_cap=cc)
    return shard_shapes(specs, sh, HALO_KEYS)


def nbytes(shards):
    return int(sum(np.prod(s) * np.dtype(d).itemsize
                   for s, d in shards.values()))


out = {"specs": {}, "arg_bytes": {}}
for name, shape, axes in MESHES:
    mesh = make_compat_mesh(shape, axes)
    vsize = int(np.prod([mesh.shape[a] for a in axes if a != "model"]))
    for mode, engine in STEP_CASES:
        out["specs"]["%s:step:%s:%s" % (name, mode, engine)] = step_shards(
            mesh, N, M, CAP, mode, engine)
    for mode in HALO_MODES:
        out["specs"]["%s:halo:%s" % (name, mode)] = halo_shards(
            mesh, N, M, CAP, HALO[name], mode, vsize)
    for gname, mode in ROWS:
        s = SMALL[gname]
        n, m, cap = s["n_pad"], s["m_pad"], s["cap"]
        if mode in ("halo", "grid_halo"):
            sh = halo_shards(mesh, n, m, cap, max(n // vsize // 8, 128),
                             "grid" if mode == "grid_halo" else "neighbor",
                             vsize)
        else:
            sh = step_shards(mesh, n, m, cap, mode)
        out["arg_bytes"]["%s:%s:%s" % (name, gname, mode)] = nbytes(sh)
json.dump(out, open(OUT, "w"))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(the port's results over fake groups, JAX's shard shapes)."""
    d = tmp_path_factory.mktemp("dryrun_layout")
    src = os.path.join(REPO, "src")
    halo = {name: _halo(N, int(np.prod(shape[:-1])))
            for name, shape, _ in MESHES}
    head = (f"SRC = {src!r}\nMESHES = {MESHES!r}\nN, M, CAP = {N}, {M}, "
            f"{CAP}\nSMALL = {SMALL!r}\nEXACT_MAX_N = {EXACT_MAX_N}\n"
            f"ROWS = {ROWS!r}\nSTEP_CASES = {STEP_CASES!r}\n"
            f"HALO_MODES = {HALO_MODES!r}\nHALO = {halo!r}\n"
            f"PP_SMOKE = {PP_SMOKE!r}\nRING_SMOKE = {RING_SMOKE!r}\n")
    env = dict(os.environ, PYTHONPATH=src)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", head + f"OUT = {str(d / 'torch.json')!r}\n"
         + textwrap.dedent(PORT_RUN)], env=dict(env, OMP_NUM_THREADS="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
        [sys.executable, "-c", head + f"OUT = {str(d / 'jax.json')!r}\n"
         + textwrap.dedent(JAX_SHARDS)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=600)
            assert p.returncode == 0, err[-6000:]
    finally:
        for p in procs:
            p.kill()
    return (json.load(open(d / "torch.json")),
            json.load(open(d / "jax.json")))


SPEC_KEYS = ([f"{m}:step:{mode}:{e}" for m, _, _ in MESHES
              for mode, e in STEP_CASES]
             + [f"{m}:halo:{mode}" for m, _, _ in MESHES
                for mode in HALO_MODES])


@pytest.mark.parametrize("key", SPEC_KEYS)
def test_specs_equal_jax_shards(runs, key):
    got, want = runs
    assert got["specs"][key] == want["specs"][key]


def COLLECTIVES(mode: str, shape, axes) -> set:
    """(kind, group size) of every collective of one row's step, from the
    step's code (``core/distributed.py``): the all-gather step gathers the
    weights (``DistStep.stage``) and the positions over the vertex axes;
    its exact and neighbor repulsions sum over "model"; the grid
    repulsion reduces the box and the cell sums over the vertex axes and
    the far and near fields over "model"; the halo step exchanges its halo
    by one all-to-all a vertex axis, and its grid variant permutes the
    boundary rows to the neighbouring vertex ranks."""
    sizes = _axis_sizes(shape, axes)
    V = int(np.prod([s for a, s in sizes.items() if a != "model"]))
    Mo = sizes["model"]
    a2a = {("all-to-all", s) for a, s in sizes.items() if a != "model"}
    return {"neighbor": {("all-gather", V), ("all-reduce", Mo)},
            "exact": {("all-gather", V), ("all-reduce", Mo)},
            "halo": a2a,
            "grid": {("all-gather", V), ("all-reduce", V),
                     ("all-reduce", Mo)},
            "grid_halo": a2a | {("all-reduce", V), ("all-reduce", Mo),
                                ("collective-permute", V)}}[mode]


ROW_KEYS = [(name, shape, axes, g, mode) for name, shape, axes in MESHES
            for g, mode in ROWS]


@pytest.mark.parametrize("case", ROW_KEYS,
                         ids=[f"{c[0]}:{c[3]}:{c[4]}" for c in ROW_KEYS])
def test_layout_row_runs_on_meta_and_counts(runs, case):
    """The row ran to its end (``run_layout_row`` raises unless rank 0's
    output is [n_loc, 2] float32); its argument bytes equal JAX's shards';
    FLOPs, bytes and the peak counted; the collectives the step's."""
    got, want = runs
    name, shape, axes, g, mode = case
    key = f"{name}:{g}:{mode}"
    rec = got["rows"][key]
    assert rec["arch"] == f"layout_{g}_{mode}"
    assert rec["mesh"] == name
    mem, r = rec["memory"], rec["roofline"]
    assert mem["argument_bytes"] == want["arg_bytes"][key]
    assert mem["peak_bytes"] >= mem["argument_bytes"] and mem["fits_hbm"]
    assert r["flops"] > 0 and r["bytes"] > 0 and r["coll_bytes"] > 0
    assert r["flops"] == sum(rec["flops_by"].values())
    assert (rec["flops_by"]["kernels"] > 0) == mode.startswith("grid")
    ops = {(c["op"], c["group"]) for c in rec["collectives"]}
    assert ops == COLLECTIVES(mode, shape, axes)
    assert set(rec["counted_by"]) >= {"flops", "bytes", "peak_bytes",
                                      "argument_bytes", "collectives"}


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_allgather_bytes_follow_the_ring_model(runs, name):
    """The all-gather neighbor row gathers the positions (n_pad·2·4 bytes)
    and the weights (n_pad·4) over the vertex ranks: (g − 1)/g of them
    each a rank; its exact row the same at its own n_pad."""
    got, _ = runs
    for g, mode in (("fine", "neighbor"), ("coarse", "exact")):
        rec = got["rows"][f"{name}:{g}:{mode}"]
        n = SMALL[g]["n_pad"]
        ag = [c for c in rec["collectives"] if c["op"] == "all-gather"]
        assert len(ag) == 1
        gsz = ag[0]["group"]
        assert ag[0]["bytes"] == n * (2 * 4 + 4) * (gsz - 1) / gsz


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_ppermute_on_meta(runs, name):
    """``comm.ppermute`` on meta over the fake group: a ring and a pair
    that leaves rank 0 out — meta outputs of x's shape, the ring's bytes
    counted once (the pair's call involves no op of rank 0)."""
    got, _ = runs
    r = got["p2p"][f"{name}:ppermute"]
    assert r["shapes"] == [[3, 5], [3, 5]]
    assert r["devices"] == ["meta", "meta"]
    assert r["counted"] == {"collective-permute:4": 3 * 5 * 4}


@pytest.mark.parametrize("name", [m[0] for m in MESHES])
def test_halo_rows_on_meta(runs, name):
    """``_halo_rows`` on meta: zero-shaped meta rows [G, cap, 3] on both
    sides, its two permutes' bytes counted."""
    got, _ = runs
    r = got["p2p"][f"{name}:halo_rows"]
    assert r["shapes"] == [[16, 8, 3], [16, 8, 3]]
    assert r["devices"] == ["meta", "meta"]
    assert r["counted"] == {"collective-permute:4": 2 * 16 * 8 * 3 * 4}


def test_pp_smoke_counts_the_pipeline_permutes(runs):
    """gemma-2b's smoke config in 2 stages on (2, 2, 2), 2 microbatches:
    stage 0 sends its output at each of the T = M + S − 1 ticks, and the
    backward returns the gradient of all but the first tick's (a constant
    zero block): (2T − 1) blocks of [rows/M, S, d_model] float32 over
    "pod" (a group of 2, as data and model are)."""
    got, _ = runs
    rec = got["pp"]
    pp = PP_SMOKE
    d_model = 64
    rows = pp["batch"] // 2 // pp["microbatches"]
    T = pp["microbatches"] + 2 - 1
    want = (2 * T - 1) * rows * pp["seq"] * d_model * 4
    perm = [c for c in rec["collectives"] if c["op"] == "collective-permute"]
    assert perm == [{"op": "collective-permute", "group": 2, "bytes": want}]
    assert rec["roofline"]["flops"] > rec["flops_by"]["matmul"] > 0
    assert rec["memory"]["peak_bytes"] > rec["memory"]["argument_bytes"] > 0
    assert rec["opts"]["dtype"] == "float32"


def test_ring_smoke_counts_the_kv_rotations(runs):
    """Ring attention on (2, 4): its loop rotates k and v once each a step
    but the last, 2·(size − 1) blocks [B/2, S/4, KV, hd] float32 over
    "model"."""
    got, _ = runs
    rec = got["ring"]
    r = RING_SMOKE
    block = r["B"] // 2 * r["S"] // 4 * r["KV"] * r["hd"] * 4
    assert rec["collectives"] == [{"op": "collective-permute", "group": 4,
                                   "bytes": 2 * 3 * block}]
    assert rec["roofline"]["flops"] > rec["flops_by"]["matmul"] > 0
    assert rec["mesh"] == "2x4"
