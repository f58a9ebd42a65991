"""The port's dry run (``repro_torch.launch.dryrun``'s ``lm`` suite and
what it reads) against the live JAX package on the CPU.

In process, exactly equal: ``analytic_cell`` (bytes and peak) for every
registered config × shape cell × mesh ((4, 2), (1, 8), (2, 2, 2), (16,
16), (2, 16, 16)) × option set, ``cells_for`` and ``active_param_count``
of every config; ``cell_opts_for`` against the JAX package's escalation
rule at the H100's 80 GB; ``utils/tree.py`` on a nested tree of meta
tensors.

The dry run at mesh (4, 2) on every smoke config and cell kind (train_4k
in four option sets — the default, FSDP, no ZeRO-1, the ``fsdp_dp``
strategy —, prefill_32k plain and in two chunks, decode_32k, and long_500k
where the config runs it): the port's ``run_cell`` runs each step to its
end on meta tensors over a fake 8-rank group in a subprocess, and the
bytes rank 0 holds — weights, AdamW state and gradients, decode state —
equal, part by part, the sum over the same leaves of JAX's
``NamedSharding(mesh, spec).shard_shape`` (times each leaf's itemsize in
the port) with JAX's specs (``param_specs``, ``zero_shardings``, the
``fsdp_dp`` spec of its ``lower_cell``, ``decode_state_specs``), run on 8
host devices in another subprocess, both at once. The CLI writes one
record a cell, the ``layout`` and ``pp`` suites theirs (held to JAX in
``test_torch_dryrun_layout.py``), and refuses a suite it does not have;
``launch/report.py`` renders the records.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import cells_for as jax_cells_for
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs import list_archs
from repro.launch.analytic import analytic_cell as jax_analytic_cell
from repro_torch.configs import SHAPES, cells_for, get_config
from repro_torch.configs import get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.analytic import analytic_cell
from repro_torch.models import model as M
from repro_torch.utils.tree import tree_bytes, tree_cast, tree_count

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

MESH_SHAPES = {"4x2": {"data": 4, "model": 2},
               "1x8": {"data": 1, "model": 8},
               "2x2x2": {"pod": 2, "data": 2, "model": 2},
               "16x16": {"data": 16, "model": 16},
               "2x16x16": {"pod": 2, "data": 16, "model": 16}}
ANALYTIC_OPTS = [dict(), dict(remat=False), dict(zero_opt=False),
                 dict(fsdp=True), dict(seq_shard=True), dict(accum=4),
                 dict(strategy="fsdp_dp"), dict(fsdp=True, accum=2,
                                                seq_shard=True)]

# the dry-run cells at (4, 2): (cell, CellOpts fields)
RUN_OPTS = {"train_4k": [dict(remat="full"), dict(remat="full", fsdp=True),
                         dict(remat="full", zero_opt=False),
                         dict(remat="none", strategy="fsdp_dp")],
            "prefill_32k": [dict(remat="none"), dict(remat="none", accum=2)],
            "decode_32k": [dict(remat="none")],
            "long_500k": [dict(remat="none")]}


def run_cases() -> list:
    """(arch, cell, options index) of every dry-run case at (4, 2)."""
    return [(arch, cell.name, i) for arch in list_archs()
            for cell in cells_for(get_smoke_config(arch))
            for i in range(len(RUN_OPTS[cell.name]))]


@pytest.mark.parametrize("mesh", list(MESH_SHAPES))
@pytest.mark.parametrize("smoke", [True, False], ids=["smoke", "full"])
def test_analytic_cell_equals_jax(mesh, smoke):
    shape = MESH_SHAPES[mesh]
    for arch in list_archs():
        jcfg = (jax_get_smoke_config if smoke else jax_get_config)(arch)
        cfg = (get_smoke_config if smoke else get_config)(arch)
        for name in SHAPES:
            for kw in ANALYTIC_OPTS:
                got = analytic_cell(cfg, SHAPES[name], shape, **kw)
                want = jax_analytic_cell(jcfg, JAX_SHAPES[name], shape, **kw)
                assert got == want, (arch, name, kw)


@pytest.mark.parametrize("arch", list_archs())
def test_cells_and_active_params_equal_jax(arch):
    for smoke in (True, False):
        jcfg = (jax_get_smoke_config if smoke else jax_get_config)(arch)
        cfg = (get_smoke_config if smoke else get_config)(arch)
        assert ([c.name for c in cells_for(cfg)]
                == [c.name for c in jax_cells_for(jcfg)])
        assert cfg.active_param_count() == jcfg.active_param_count()
        assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", list_archs())
def test_cell_opts_follow_the_jax_rule_at_80_gb(arch, monkeypatch):
    """``cell_opts_for`` is the JAX package's escalation with the H100's
    80 GB in place of the v5e's 16 GiB: the JAX function, with its
    module's ``HBM_PER_CHIP`` set to 80e9, gives the same options."""
    old = os.environ.get("XLA_FLAGS")
    try:
        import repro.launch.dryrun as JD
    finally:
        if old is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = old
    monkeypatch.setattr(JD, "HBM_PER_CHIP", 80e9)
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    for cell in cells_for(cfg):
        for shape in (None, MESH_SHAPES["2x16x16"]):
            got = D.cell_opts_for(cfg, cell, shape)
            want = JD.cell_opts_for(jcfg, JAX_SHAPES[cell.name], shape)
            assert vars(got) == vars(want), (cell.name, shape)


def test_tree_utils_count_meta_tensors():
    t = {"a": torch.empty(3, 4, device="meta"),
         "b": [torch.empty(5, dtype=torch.bfloat16, device="meta"),
               (torch.empty(2, 2, dtype=torch.int32, device="meta"), None)],
         "c": 7}
    assert tree_count(t) == 12 + 5 + 4
    assert tree_bytes(t) == 48 + 10 + 16
    c = tree_cast(t, torch.bfloat16)
    assert c["a"].dtype == torch.bfloat16 and c["c"] == 7
    assert c["b"][1][0].dtype == torch.int32
    assert tree_bytes(c) == 24 + 10 + 16


# -- the dry run at (4, 2) against JAX's shard shapes ------------------------------

TORCH_RUN = """
import json, sys
sys.path.insert(0, SRC)
from repro_torch.configs import SHAPES, get_smoke_config
from repro_torch.launch import dryrun as D
from repro_torch.launch.mesh import make_fake_mesh, shutdown
mesh = make_fake_mesh((4, 2))
out = {}
for arch, cell, i in CASES:
    opts = D.CellOpts(**RUN_OPTS[cell][i])
    rec = D.run_cell(get_smoke_config(arch), SHAPES[cell], mesh, opts)
    out["%s:%s:%d" % (arch, cell, i)] = rec
shutdown()
json.dump(out, open(OUT, "w"))
"""

JAX_SHARDS = """
import json, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.mesh import make_compat_mesh
mesh = make_compat_mesh((4, 2), ("data", "model"))
import repro.launch.dryrun as JD
import repro.parallel.sharding as SH
from repro.configs import SHAPES, get_smoke_config
from repro.models import model as M
from repro.utils.tree import tree_cast
sys.path.insert(0, SRC)
from repro_torch import convert
from repro_torch.configs import get_smoke_config as port_smoke
from repro_torch.models.model import LM

is_p = lambda x: isinstance(x, P)


def shapes_by_name(shardings, struct, model):
    # each leaf's shard shape, a zeros array of it under the port's names
    tree = jax.tree.map(lambda sh, s: np.zeros(sh.shard_shape(s.shape),
                                               np.int8), shardings, struct)
    return {k: list(v.shape) for k, v in convert.lm_leaves(tree,
                                                            model).items()}


out = {}
for arch, cell, i in CASES:
    o = RUN_OPTS[cell][i]
    cfg = get_smoke_config(arch)
    rules = SH.make_rules(mesh, cfg, strategy=o.get("strategy", "tp"))
    model = LM(port_smoke(arch), device="meta")
    pspec = M.param_specs(cfg, rules)
    struct = jax.eval_shape(lambda: tree_cast(
        M.init_params(cfg, jax.random.PRNGKey(0)), jnp.bfloat16))
    if o.get("strategy") == "fsdp_dp":       # lower_cell's fsdp_dp layout
        def one(spec, ref):
            used = set()
            for e in spec:
                if e is not None:
                    used.update(e if isinstance(e, tuple) else (e,))
            free = tuple(a for a in mesh.axis_names if a not in used)
            return NamedSharding(mesh, SH.zero_spec(spec, ref.shape, mesh,
                                                    axes=free))
        pshard = jax.tree.map(one, pspec, struct, is_leaf=is_p)
    elif o.get("fsdp"):
        pshard = SH.zero_shardings(mesh, pspec, struct)
    else:
        pshard = JD._shardings_for(mesh, pspec)
    rec = {"weights": shapes_by_name(pshard, struct, model)}
    c = SHAPES[cell]
    if c.kind == "train":
        zshard = (SH.zero_shardings(mesh, pspec, struct)
                  if o.get("zero_opt", True) else pshard)
        rec["optimizer"] = shapes_by_name(zshard, struct, model)
    else:
        B, L = c.global_batch, JD._dec_len(cfg, c)
        sstruct = jax.eval_shape(lambda: M.init_decode_state(cfg, B, L))
        specs = JD.decode_state_specs(cfg, rules, B)

        def shard_shapes(st, sp):
            # one layer's (k, v) or (conv, h) shard shapes
            kind, keys = (("kv", ("k", "v")) if "kv" in st
                          else ("ssm", ("conv", "h")))
            return [list(NamedSharding(mesh, sp[kind][k]).shard_shape(
                st[kind][k].shape)) for k in keys]
        layers = []
        for st, sp in zip(sstruct.get("prefix", []),
                          specs.get("prefix", [])):
            layers += shard_shapes(st, sp)
        n_pre = len(sstruct.get("prefix", []))
        pat = cfg.layer_pattern()
        for li in range(n_pre, cfg.n_layers):
            g = (li - n_pre) % len(pat)
            layers += [s[1:] for s in shard_shapes(sstruct["groups"][g],
                                                   specs["groups"][g])]
        rec["decode_state"] = layers
    out["%s:%s:%d" % (arch, cell, i)] = rec
json.dump(out, open(OUT, "w"))
"""


@pytest.fixture(scope="module")
def dryruns(tmp_path_factory):
    """(the port's records, JAX's shard shapes), by case."""
    d = tmp_path_factory.mktemp("dryrun")
    src = os.path.join(REPO, "src")
    head = (f"SRC = {src!r}\nCASES = {run_cases()!r}\n"
            f"RUN_OPTS = {RUN_OPTS!r}\n")
    env = dict(os.environ, PYTHONPATH=src)
    env.pop("XLA_FLAGS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c",
         head + f"OUT = {str(d / 'torch.json')!r}\n"
         + textwrap.dedent(TORCH_RUN)], env=dict(env, OMP_NUM_THREADS="1"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True),
        subprocess.Popen(
        [sys.executable, "-c",
         head + f"OUT = {str(d / 'jax.json')!r}\n"
         + textwrap.dedent(JAX_SHARDS)],
        env=dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8"),
        stdout=subprocess.DEVNULL, stderr=subprocess.PIPE, text=True)]
    try:
        for p in procs:
            _, err = p.communicate(timeout=900)
            assert p.returncode == 0, err[-6000:]
    finally:
        for p in procs:
            p.kill()
    return (json.load(open(d / "torch.json")),
            json.load(open(d / "jax.json")))


def _nbytes(shapes: dict, dtype_of) -> int:
    return sum(int(np.prod(s)) * dtype_of(n) for n, s in shapes.items())


@pytest.mark.parametrize("case", run_cases(),
                         ids=lambda c: f"{c[0]}:{c[1]}:{c[2]}")
def test_dry_run_resident_bytes_equal_jax_shards(dryruns, case):
    """The step ran on meta (a record exists) and rank 0's bytes equal the
    sum of JAX's shard shapes over the same leaves, part by part."""
    got, want = dryruns
    key = "%s:%s:%d" % case
    rec, jax_shapes = got[key], want[key]
    res = rec["memory"]["resident_bytes"]
    model = M.LM(get_smoke_config(case[0]), device="meta")
    size = {n: p.element_size() for n, p in model.named_parameters()}
    assert res["weights"] == _nbytes(jax_shapes["weights"], size.get)
    if "optimizer" in jax_shapes:
        assert res["optimizer"] == 3 * _nbytes(jax_shapes["optimizer"],
                                               lambda n: 4) + 4
        assert res["gradients"] == res["weights"]
    else:
        assert res["decode_state"] == sum(
            int(np.prod(s)) * 2 for s in jax_shapes["decode_state"])
    assert res["total"] == sum(v for k, v in res.items() if k != "total")
    r = rec["roofline"]
    assert r["flops"] > 0 and r["bytes_analytic"] > 0
    assert rec["memory"]["peak_bytes_analytic"] > 0


def test_dry_run_counts_the_collectives(dryruns):
    """At (4, 2) with TP a train step all-reduces over the model axis (the
    row-parallel sums) and the batch axis (the gradients), and a decode
    step under ``kv_seq`` (gemma-2b's single KV head) gathers q's heads
    and merges the partial softmaxes."""
    got, _ = dryruns
    ops = {(c["op"], c["group"]) for c in
           got["internlm2-1.8b:train_4k:0"]["collectives"]}
    assert ("all-reduce", 2) in ops and ("all-reduce", 4) in ops
    ops = {c["op"] for c in got["gemma-2b:decode_32k:0"]["collectives"]}
    assert {"all-reduce", "all-gather"} <= ops


def test_cli_writes_records_and_refuses_other_suites(tmp_path):
    """``--suite lm --mesh single --arch gemma-2b --cell decode_32k`` at
    full size writes one record; ``--suite layout --mesh single`` writes
    the layout suite's 10 records and ``--suite pp`` the pp suite's 2, all
    at full size; the report renders them all; a suite the dry run does
    not have is refused."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out_dir = tmp_path / "dry"
    runs = [["--suite", "lm", "--mesh", "single", "--arch", "gemma-2b",
             "--cell", "decode_32k"],
            ["--suite", "layout", "--mesh", "single"],
            ["--suite", "pp"]]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *argv, "--out",
         str(out_dir)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for argv in runs]
    outs = []
    try:
        for p in procs:
            stdout, stderr = p.communicate(timeout=600)
            assert p.returncode == 0, stderr[-4000:]
            outs.append(stdout)
    finally:
        for p in procs:
            p.kill()
    assert "1/1 OK" in outs[0]
    assert "10/10 OK" in outs[1]
    assert "2/2 OK" in outs[2]
    rec = json.load(open(out_dir / "pod16x16" / "gemma-2b__decode_32k.json"))
    assert rec["mesh"] == "16x16" and rec["memory"]["fits_hbm"]
    layout = sorted(p.name for p in (out_dir / "pod16x16").glob("layout_*"))
    assert len(layout) == 10
    assert "layout_coarse_level_exact__layout_step.json" in layout
    assert "layout_hugetric_like_grid_halo__layout_step.json" in layout
    for name in layout:
        r = json.load(open(out_dir / "pod16x16" / name))
        assert r["memory"]["argument_bytes"] > 0 and r["collectives"]
        assert r["memory"]["fits_hbm"] and r["roofline"]["flops"] > 0
    pp = json.load(open(out_dir / "pods2x16x16"
                        / "gemma-2b-pp2__train_fwd_bwd.json"))
    ring = json.load(open(out_dir / "pod16x16"
                          / "ring-attention-32k__prefill_attn_layer.json"))
    assert {c["op"] for c in pp["collectives"]} >= {"collective-permute"}
    assert ring["collectives"][0]["op"] == "collective-permute"
    from repro_torch.launch import report
    txt = report.main(["--root", str(out_dir),
                       "--out", str(tmp_path / "roofline.md")])
    for row in ("| gemma-2b | decode_32k |", "| gemma-2b-pp2 | train_fwd_bwd",
                "| ring-attention-32k | prefill_attn_layer",
                "| layout_hugetric_like_grid | layout_step |"):
        assert row in txt
    with pytest.raises(SystemExit):
        D.main(["--suite", "nosuch"])
