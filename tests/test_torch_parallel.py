"""Port parity of ``repro_torch.parallel`` (``sharding.py``, ``comm.py``,
``collectives.ring_collective_matmul``, ``ring_attention.py``,
``pipeline.py``) and of ``models/moe.py``'s expert-parallel forms against
the live JAX package on the CPU.

In process: ``make_rules``, ``zero_spec`` and ``param_specs`` against
JAX's for every registered config at meshes (4, 2), (1, 8) and (2, 2, 2),
in every strategy, ``seq_shard`` and ``moe_impl`` (JAX's ``make_rules``
reads only ``mesh.axis_names`` and ``mesh.shape``, so a stand-in mesh
serves both).

The sharded cases of ``test_distributed.py`` at its shapes: the JAX side
runs them in one subprocess with 8 host devices, the port's in one spawn
of 8 gloo ranks (``tests/torch_parallel_ranks.py``, meeting through a
``FileStore``), both at once, from inputs made here from numpy seeds.
Bounds: JAX's own (ring matmul rtol = atol = 1e-4; ring attention float32
2e-5, bf16 3e-2; both MoE forms 1e-4), held against JAX's form and the
plain reference alike. The pipeline (internlm2 smoke, JAX's weights,
float32): logits within 1e-4 of JAX's ``forward`` (JAX's bound for its
own pipeline is 0.05), and each gradient leaf within 1e-4 of its largest
|value| of the port's unpipelined autograd gradient, nonzero. Rings of one
rank equal the plain product / attention; an uneven split (d_ff 100 over
8 ranks) gives the unsharded loss and gradients within 1e-5 / 1e-4.
"""
import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
import repro.models.model as jax_model
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs import list_archs
from repro.models.layers import _sdpa
from repro.models.model import param_specs as jax_param_specs
from repro.parallel.sharding import make_rules as jax_make_rules
from repro.parallel.sharding import zero_spec as jax_zero_spec
from jax.sharding import PartitionSpec as P
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.parallel import sharding as SH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-4

JAX_CASES = """
import dataclasses
import numpy as np, jax, jax.numpy as jnp
from repro.launch.mesh import make_compat_mesh
from repro.configs.base import MoEConfig
from repro.models import moe as MOE
from repro.parallel.collectives import ring_collective_matmul
from repro.parallel.ring_attention import ring_attention
from repro.parallel.sharding import make_rules, use_shardings
inp = dict(np.load(INP))
out = {}
a = jnp.asarray
m18 = make_compat_mesh((1, 8), ("data", "model"))
m24 = make_compat_mesh((2, 4), ("data", "model"))
out["rcm"] = jax.jit(ring_collective_matmul(m18, "model"))(
    a(inp["rcm_x"]), a(inp["rcm_w"]))
for dt in ("float32", "bfloat16"):
    q, k, v = (a(inp["ra_" + n], getattr(jnp, dt)) for n in "qkv")
    for causal in (True, False):
        out["ra_%s_%s" % (dt, causal)] = jax.jit(ring_attention(
            m24, causal=causal))(q, k, v).astype(jnp.float32)
m = MoEConfig(n_experts=8, top_k=2, d_expert=16, capacity_factor=2.0)
p = {k: a(inp["moe_" + k]) for k in ("router", "wup", "wgate", "wdown")}
rules = dataclasses.replace(make_rules(m24, None), experts="model")
with use_shardings(m24, rules):
    out["moe_shardmap"] = jax.jit(lambda p, x: MOE.apply_moe_shardmap(
        p, x, m))(p, a(inp["moe_x1"]))[0]
m4 = dataclasses.replace(m, capacity_factor=4.0)
rules = dataclasses.replace(make_rules(m24, None), experts="model",
                            batch=("data", "model"), moe_impl="all_to_all")
with use_shardings(m24, rules):
    out["moe_a2a"] = jax.jit(lambda p, x: MOE.apply_moe_a2a(
        p, x, m4))(p, a(inp["moe_x2"]))[0]
np.savez(OUT, **{k: np.asarray(v) for k, v in out.items()})
"""


class _Mesh:
    """A stand-in mesh: all that ``make_rules`` and ``zero_spec`` read."""

    def __init__(self, shape, axes):
        self.axis_names = tuple(axes)
        self.shape = dict(zip(axes, shape))


MESHES = {"4x2": ((4, 2), ("data", "model")),
          "1x8": ((1, 8), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model"))}
FLAGS = [dict(strategy=s, seq_shard=q, moe_impl=i)
         for s in ("tp", "fsdp_dp") for q in (False, True)
         for i in ("gspmd", "shard_map", "all_to_all")]


def _spec_leaves(tree, cfg, model):
    """JAX's spec tree by the port's parameter names, each scanned layer's
    spec without its leading group entry."""
    def stacked(sub, n):
        if isinstance(sub, dict):
            return {k: stacked(v, n) for k, v in sub.items()}
        arr = np.empty(n, object)
        for g in range(n):
            arr[g] = tuple(sub)[1:]
        return arr

    def flat(sub):
        if isinstance(sub, dict):
            return {k: flat(v) for k, v in sub.items()}
        if isinstance(sub, list):
            return [flat(v) for v in sub]
        return tuple(sub)

    t = {k: flat(v) for k, v in tree.items()
         if k not in ("groups", "encoder")}
    n_pre = len(tree.get("prefix", []))
    G = (cfg.n_layers - n_pre) // len(cfg.layer_pattern())
    t["groups"] = [stacked(g, G) for g in tree["groups"]]
    if "encoder" in tree:
        t["encoder"] = stacked(tree["encoder"], cfg.enc_layers)
    return {k: tuple(v) for k, v in convert.lm_leaves(t, model).items()}


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_rules_and_specs_equal_jax(mesh_name):
    """``make_rules``, ``param_specs`` and ``zero_spec`` of every leaf equal
    JAX's, for every registered config (and no config) in every strategy
    and flag."""
    mesh = _Mesh(*MESHES[mesh_name])
    fields = [f.name for f in dataclasses.fields(SH.ShardingRules)
              if f.name != "mesh"]
    for arch in [None, *list_archs()]:
        jcfg = arch and jax_get_smoke_config(arch)
        cfg = arch and get_smoke_config(arch)
        model = arch and M.LM(cfg, device="meta")
        for flags in FLAGS:
            jr = jax_make_rules(mesh, jcfg, **flags)
            r = SH.make_rules(mesh, cfg, **flags)
            assert ([getattr(r, f) for f in fields]
                    == [getattr(jr, f) for f in fields]), (arch, flags)
            if arch is None:
                continue
            want = _spec_leaves(jax_param_specs(jcfg, jr), cfg, model)
            got = M.param_specs(cfg, r)
            assert got == want, (arch, flags)
            for name, p in model.named_parameters():
                z = SH.zero_spec(got[name], p.shape, mesh)
                assert z == tuple(jax_zero_spec(P(*want[name]), p.shape,
                                                mesh)), (arch, name)
                assert SH.zero_shardings(mesh, {name: got[name]},
                                         {name: p.shape})[name] == z


def _inputs() -> dict:
    rng = np.random.default_rng(0)
    inp = {"rcm_x": rng.normal(size=(64, 32)).astype(np.float32),
           "rcm_w": rng.normal(size=(32, 48)).astype(np.float32)}
    for n, h in (("q", 4), ("k", 2), ("v", 2)):
        inp["ra_" + n] = rng.normal(size=(2, 256, h, 32)).astype(np.float32)
    inp["moe_router"] = (rng.normal(size=(32, 8)) * 32 ** -0.5
                         ).astype(np.float32)
    for n, shape, s in (("wup", (8, 32, 16), 32), ("wgate", (8, 32, 16), 32),
                        ("wdown", (8, 16, 32), 16)):
        inp["moe_" + n] = (rng.normal(size=shape) * s ** -0.5
                           ).astype(np.float32)
    inp["moe_x1"] = rng.normal(size=(4, 32, 32)).astype(np.float32)
    inp["moe_x2"] = rng.normal(size=(8, 32, 32)).astype(np.float32)
    cfg = jax_get_smoke_config("internlm2-1.8b")
    params = jax.tree.map(np.asarray, jax_model.init_params(
        cfg, jax.random.PRNGKey(0)))
    model = M.LM(get_smoke_config("internlm2-1.8b"), device="meta")
    for k, v in convert.lm_leaves(params, model).items():
        inp["pp_" + k] = np.asarray(v, np.float32)
    inp["pp_tokens"] = rng.integers(0, cfg.vocab, (8, 64)).astype(np.int64)
    inp["un_tokens"] = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64)
    labels = rng.integers(0, cfg.vocab, (4, 32)).astype(np.int64)
    labels[0, :3] = -1
    inp["un_labels"] = labels
    return inp, params


def _jax_refs(inp, params) -> dict:
    """The single-device references: ``_sdpa`` of the attention inputs and
    JAX's float32 ``forward`` of the pipeline's batch."""
    ref = {}
    for dt in ("float32", "bfloat16"):
        q, k, v = (jnp.asarray(inp["ra_" + n], getattr(jnp, dt))
                   for n in "qkv")
        for causal in (True, False):
            ref[f"sdpa_{dt}_{causal}"] = np.asarray(
                _sdpa(q, k, v, causal=causal).astype(jnp.float32))
    cfg = jax_get_smoke_config("internlm2-1.8b")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "ACT_DTYPE", jnp.float32)
        mp.setattr(jax_model, "ACT", jnp.float32)
        logits, _ = jax_model.forward(
            params, cfg, {"tokens": jnp.asarray(inp["pp_tokens"], jnp.int32)})
    ref["forward"] = np.asarray(logits, np.float32)
    return ref


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, JAX's sharded results, its single-device references, the
    port's results): JAX's 8-device side and the port's 8 ranks run at
    once, in their own processes, while this one computes the
    references."""
    d = tmp_path_factory.mktemp("parallel")
    inp, params = _inputs()
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = f"INP, OUT = {str(d / 'inputs.npz')!r}, {str(d / 'jax.npz')!r}\n"
    jax_p = subprocess.Popen([sys.executable, "-c",
                              code + textwrap.dedent(JAX_CASES)],
                             env=jenv, stdout=subprocess.PIPE,
                             stderr=subprocess.PIPE, text=True)
    torch_p = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_parallel_ranks.py"),
         str(d / "inputs.npz"), str(d)], env=dict(env, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        refs = _jax_refs(inp, params)
        outs = {}
        for name, p in (("jax", jax_p), ("torch", torch_p)):
            so, se = p.communicate(timeout=900)
            assert p.returncode == 0, f"{name}:\n{se[-6000:]}"
            outs[name] = dict(np.load(d / f"{name}.npz"))
    finally:
        for p in (jax_p, torch_p):
            p.kill()
    return inp, outs["jax"], refs, outs["torch"]


def _close(got, ref, tol=TOL):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    np.testing.assert_allclose(got, ref, rtol=tol, atol=tol)


def test_ring_collective_matmul_matches_allgather_and_jax(runs):
    inp, jx, _, got = runs
    _close(got["rcm"], inp["rcm_x"] @ inp["rcm_w"])
    _close(got["rcm"], jx["rcm"])


@pytest.mark.parametrize("dt,tol", [("float32", 2e-5), ("bfloat16", 3e-2)])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_attention_matches_sdpa_and_jax(runs, dt, tol, causal):
    """At (2, 4), S 256 over 4 ranks, GQA 4/2: max |Δ| within JAX's bound
    of its ``_sdpa`` and of JAX's ring attention."""
    _, jx, refs, got = runs
    key = f"{dt}_{causal}"
    for ref in (refs["sdpa_" + key], jx["ra_" + key]):
        assert np.abs(got["ra_" + key] - ref).max() < tol, key


@pytest.mark.parametrize("form", ["moe_shardmap", "moe_a2a"])
def test_moe_forms_match_apply_moe_and_jax(runs, form):
    """``apply_moe_shardmap`` at (2, 4), x (4, 32, 32), capacity 2.0, and
    ``apply_moe_a2a`` with the batch over data × model, x (8, 32, 32),
    capacity 4.0: within 1e-4 of the plain ``apply_moe`` and of JAX's form
    (the EP form under the rules' default ``apply_moe`` too)."""
    _, jx, _, got = runs
    assert np.abs(got[form] - got[form + "_plain"]).max() < TOL
    assert np.abs(got[form] - jx[form]).max() < TOL
    if form == "moe_shardmap":
        np.testing.assert_array_equal(got[form], got[form + "_gspmd"])


def test_pipeline_forward_matches_forward(runs):
    """GPipe at (2, 2, 2), 4 microbatches: the logits within 1e-4 of JAX's
    float32 ``forward`` and of the port's; with ``remat="full"`` the same
    logits."""
    _, _, refs, got = runs
    _close(got["pp"], refs["forward"])
    _close(got["pp"], got["pp_forward"])
    np.testing.assert_array_equal(got["pp_remat"], got["pp"])


@pytest.mark.parametrize("tag", ["pp", "pp_remat"])
def test_pipeline_gradient_is_the_unpipelined_one(runs, tag):
    """Every parameter's gradient through the pipeline (reverse schedule by
    autograd through the handoffs) equals the unpipelined autograd
    gradient within 1e-4 of the leaf's largest |value|, and is nonzero."""
    _, _, _, got = runs
    names = [k[len("pp_ref_grad_"):] for k in got
             if k.startswith("pp_ref_grad_")]
    assert names
    for k in names:
        ref = got["pp_ref_grad_" + k]
        g = got[f"{tag}_grad_{k}"]
        scale = np.abs(ref).max()
        assert scale > 0 and np.abs(g).max() > 0, k
        assert np.abs(g - ref).max() <= TOL * scale, k


def test_rings_of_one_rank_equal_the_plain_versions(runs):
    """An axis of size 1 sends nothing: the ring matmul is ``x @ w`` bit for
    bit, ring attention the plain attention within float32 / bf16 noise,
    and a one-stage pipeline (1, 4, 2) the ``forward``."""
    _, _, _, got = runs
    np.testing.assert_array_equal(got["rcm1"], got["rcm1_plain"])
    for dt, tol in (("float32", 2e-5), ("bfloat16", 3e-2)):
        for causal in (True, False):
            key = f"{dt}_{causal}"
            assert np.abs(got["ra1_" + key]
                          - got["ra1_plain_" + key]).max() < tol, key
    _close(got["pp1"], got["pp_forward"])


def test_uneven_split_gives_the_unsharded_loss_and_gradients(runs):
    """d_ff 100 over a model axis of 8: blocks of 13 and a last one of 9;
    loss within 1e-5 and each gradient leaf within 1e-4 of its max."""
    _, _, _, got = runs
    assert list(got["un_dff_blocks"]) == [13] * 7 + [9]
    np.testing.assert_allclose(got["un_loss"], got["un_loss_plain"],
                               rtol=1e-5)
    for k in got:
        if k.startswith("un_plain_grad_"):
            ref = got[k]
            g = got["un_grad_" + k[len("un_plain_grad_"):]]
            assert np.abs(g - ref).max() <= TOL * np.abs(ref).max(), k
