"""The port's sharded trainer against the live JAX package on the CPU: the
sharded loss and gradients of every registered model's smoke config, the
sequence-parallel and fsdp_dp strategies, one sharded AdamW step with and
without int8 compression, ``launch/train.py --model-parallel 2`` against
JAX's driver on 8 host devices, and the elastic restore of its checkpoint
at other meshes and on one rank.

The port's side runs in one spawn of 8 gloo ranks
(``tests/torch_train_parallel_ranks.py``, meeting through a ``FileStore``),
JAX's driver in one subprocess with 8 host devices, both at once, while
this process computes JAX's single-device references (as
``test_distributed.py:52`` holds JAX's sharded loss to the unsharded one).
Every model starts from JAX's ``init_params`` weights; the batch is JAX's
``batch_at`` (B 8 × S 64, 3 labels masked) with its ``extra_inputs``. In
bf16 the port's MoE routers follow JAX's recorded top-k choices (the
port's own probabilities gathered at JAX's indices, as
``torch_train_cases`` does): a near-tie that bf16 noise flips would move a
whole expert's gradient.

Tolerances:
- float32 (the JAX side switched to float32 as ``torch_train_cases``
  does): loss rtol 1e-5, each gathered gradient leaf within 1e-4 of the
  leaf's largest |JAX value|;
- bf16: the LM tolerances, loss rtol 0.02 / atol 0.1 and each leaf within
  rtol 0.02 + 0.1 × its max; a leaf outside it is held to the port's
  float32 sharded gradient, no further from it than twice JAX's bf16 one
  (the SSD's per-head ``A_log``, a sum over every position, as in
  ``test_torch_train_grads_bf16.py``);
- the AdamW step on the same gradients: masters, mu, nu and the error
  state within rtol 1e-6 of JAX's (atol 1e-6 × the leaf's max: the clip
  norm's sum order);
- the driver's per-step losses (printed to 4 decimals): the bf16
  tolerance against JAX's driver and against the uninterrupted run.
"""
import os
import re
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_train_cases import ClampedExpNumpy, _top_k

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
import repro.models.model as jax_model
import repro.models.moe as jax_moe
import repro.models.ssm as jax_ssm
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.parallel.collectives import compress_grads as jax_compress
from repro.parallel.collectives import decompress_grads as jax_decompress
from repro.parallel.collectives import init_error_state as jax_init_error
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import DataConfig as JaxDataConfig
from repro.train import batch_at as jax_batch_at
from repro.train import extra_inputs as jax_extra_inputs
from repro.train.optim import apply_updates as jax_apply_updates
from repro.train.optim import init_opt_state as jax_init_opt_state
from repro_torch import convert
from repro_torch.ckpt import restore_checkpoint, save_checkpoint
from repro_torch.configs import get_smoke_config
from repro_torch.launch import train as T
from repro_torch.models import model as M
from repro_torch.train import TrainConfig, init_train_state

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_train_parallel_ranks import ARCHS, LAUNCH, MESHES  # noqa: E402

B, S = 8, 64
OPTIM = dict(lr=3e-4, warmup_steps=5, total_steps=30)
BF16 = dict(rtol=0.02, atol=0.1)

JAX_MAIN = """
from repro.launch.train import main
main(ARGV)
"""


def _np(x):
    return np.asarray(x, np.float32)


def _inputs():
    """Each model's JAX weights (float32, by the port's names) and batch,
    the drawn AdamW gradients → (inputs, {arch: JAX params}, {arch: JAX
    batch})."""
    inp, params, batches = {}, {}, {}
    for arch in ARCHS:
        cfg = jax_get_smoke_config(arch)
        p = jax.tree.map(np.asarray, jax_model.init_params(
            cfg, jax.random.PRNGKey(0)))
        params[arch] = p
        model = M.LM(get_smoke_config(arch), device="meta")
        for k, v in convert.lm_leaves(p, model).items():
            inp[f"{arch}:w:{k}"] = _np(v)
        jb = jax_batch_at(JaxDataConfig(vocab=cfg.vocab, seq_len=S,
                                        global_batch=B), 0)
        labels = np.array(jb["labels"])
        labels[0, :3] = -1
        jb["labels"] = jnp.asarray(labels)
        jb.update(jax_extra_inputs(cfg, B, S))
        batches[arch] = jb
        for k, a in jb.items():
            inp[f"{arch}:b:{k}"] = (_np(a) if a.dtype == jnp.bfloat16
                                    else np.asarray(a))
    rng = np.random.default_rng(7)
    for k, v in list(inp.items()):
        if k.startswith("internlm2-1.8b:w:"):
            inp["adamw:g:" + k.split(":w:", 1)[1]] = (
                rng.normal(size=v.shape) * 1e-2).astype(np.float32)
    return inp, params, batches


def _jax_grads(arch, params, batches, ref) -> list:
    """JAX's single-device loss and gradients (by the port's names) of
    ``arch`` in both dtypes into ``ref`` → its bf16 MoE routes: the top-k
    experts [B, S, k] of each MoE call, in call order."""
    cfg = jax_get_smoke_config(arch)
    model = M.LM(get_smoke_config(arch), device="meta")
    rec = []
    real = jax_moe.apply_moe

    def recorded(p, x, m, activation="swiglu"):
        probs = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", x.astype(jnp.float32), p["router"]), axis=-1)
        jax.debug.callback(lambda a: rec.append(np.asarray(a)), probs,
                           ordered=True)
        return real(p, x, m, activation)

    for dt in ("float32", "bfloat16"):
        rec.clear()
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_layers, "ACT_DTYPE", getattr(jnp, dt))
            mp.setattr(jax_model, "ACT", getattr(jnp, dt))
            mp.setattr(jax_ssm, "jnp", ClampedExpNumpy())
            mp.setattr(jax_moe, "apply_moe", recorded)
            (loss, _), g = jax.jit(jax.value_and_grad(
                lambda p, b: jax_model.loss_fn(p, cfg, b),
                has_aux=True))(params[arch], batches[arch])
            jax.effects_barrier()
        ref[f"{arch}:{dt}:loss"] = float(loss)
        ref[f"{arch}:{dt}:grads"] = {
            k: _np(v) for k, v in convert.lm_leaves(
                jax.tree.map(np.asarray, g), model).items()}
    return [_top_k(a, cfg.moe.top_k) for a in rec] if cfg.moe else []


def _jax_refs(params, batches, inp, ref) -> dict:
    """JAX's references of the models without MoE layers (``_jax_grads``)
    and its AdamW step on the drawn gradients, into ``ref``."""
    for arch in ARCHS:
        if jax_get_smoke_config(arch).moe is None:
            _jax_grads(arch, params, batches, ref)
    arch = "internlm2-1.8b"
    p = params[arch]
    model = M.LM(get_smoke_config(arch), device="meta")
    grads = _tree_like(p, {k: inp["adamw:g:" + k]
                           for k in convert.lm_leaves(p, model)})
    opt_cfg = JaxAdamWConfig(**OPTIM)
    for compress in (False, True):
        g = grads
        st = jax_init_opt_state(opt_cfg, p)
        if compress:
            # one scale a parameter, as the port stores them (JAX's own
            # tree stacks a scanned weight's layers into one leaf)
            flat = {k: inp["adamw:g:" + k]
                    for k in convert.lm_leaves(p, model)}
            q, err = jax_compress(flat, jax_init_error(flat))
            g = _tree_like(p, jax_decompress(q))
            ref["adamw_err"] = {k: _np(v) for k, v in err.items()}
        _, st2, om = jax_apply_updates(opt_cfg, p, g, st)
        ref[f"adamw_{compress}_gnorm"] = float(om["grad_norm"])
        for key in ("master", "mu", "nu"):
            ref[f"adamw_{compress}_{key}"] = {
                k: _np(v) for k, v in convert.lm_leaves(
                    jax.tree.map(np.asarray, getattr(st2, key)),
                    model).items()}
    return ref


def _tree_like(params, named: dict):
    """JAX's params tree with each leaf replaced by ``named``'s array of
    the port name at its place (stacked layers stacked back)."""
    G = len(params["groups"][0]["norm1"]["scale"])
    n_pre = len(params.get("prefix", []))
    per = len(params["groups"])

    def layer_tree(sub, prefix):
        if isinstance(sub, dict):
            return {k: layer_tree(v, f"{prefix}.{k}") for k, v in sub.items()}
        return named[prefix]

    out = {k: layer_tree(v, k) for k, v in params.items()
           if k not in ("groups", "prefix", "encoder")}
    if n_pre:
        out["prefix"] = [layer_tree(params["prefix"][0], "layers.0")]
    out["groups"] = [jax.tree.map(
        lambda *xs: jnp.stack(xs),
        *[layer_tree(params["groups"][i], f"layers.{n_pre + g * per + i}")
          for g in range(G)]) for i in range(per)]
    assert "encoder" not in params
    return out


def _losses(text: str) -> dict:
    """{step: loss} of a driver's printed lines."""
    return {int(s): float(v) for s, v in
            re.findall(r"step\s+(\d+) loss (\S+)", text)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(JAX's references, its driver's printed text, the port's results,
    rank 1's printed text, the output directory)."""
    d = tmp_path_factory.mktemp("train_parallel")
    inp, params, batches = _inputs()
    ref = {}
    for arch in ARCHS:          # the MoE models first: the ranks follow
        if jax_get_smoke_config(arch).moe is not None:   # their routes
            for i, idx in enumerate(_jax_grads(arch, params, batches, ref)):
                inp[f"{arch}:route:{i}"] = idx
    np.savez(d / "inputs.npz", **inp)
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8")
    argv = [a for a in LAUNCH if a not in ("--device", "cpu",
                                           "--ckpt-every", "10")]
    code = f"ARGV = {argv + ['--model-parallel', '2']!r}\n"
    jax_p = subprocess.Popen(
        [sys.executable, "-c", code + textwrap.dedent(JAX_MAIN)],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    torch_p = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_train_parallel_ranks.py"),
         str(d / "inputs.npz"), str(d)], env=dict(env, OMP_NUM_THREADS="1"),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        _jax_refs(params, batches, inp, ref)
        jso, jse = jax_p.communicate(timeout=900)
        assert jax_p.returncode == 0, jse[-6000:]
        so, se = torch_p.communicate(timeout=900)
        assert torch_p.returncode == 0, se[-6000:]
    finally:
        for p in (jax_p, torch_p):
            p.kill()
    got = dict(np.load(d / "torch.npz"))
    rank1 = dict(np.load(d / "rank1.npz"))
    return ref, jso, got, rank1, d


def _grads_close(got: dict, ref: dict, rtol, atol, truth=None):
    """Every leaf within rtol·|ref| + atol·max|ref|; with ``truth`` (the
    port's float32 gradients), a leaf outside it lies no further from
    truth than twice ref does."""
    assert set(got) == set(ref)
    for name, b in ref.items():
        a = got[name]
        scale = np.abs(b).max()
        if scale == 0:
            assert np.abs(a).max() == 0, name
            continue
        if np.all(np.abs(a - b) <= rtol * np.abs(b) + atol * scale):
            continue
        assert truth is not None, (name, np.abs(a - b).max(), scale)
        t = truth[name]
        assert (np.abs(a - t).max() <= 2 * np.abs(b - t).max()), name


@pytest.mark.parametrize("mesh", [f"{a}x{b}" for a, b in MESHES])
@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_sharded_loss_and_grads_match_jax(runs, arch, mesh, dt):
    ref, _, got, _, _ = runs
    tag = f"{arch}:{mesh}:{dt}"
    grads = {k.split(":g:", 1)[1]: v for k, v in got.items()
             if k.startswith(tag + ":g:")}
    loss, jloss = float(got[tag + ":loss"]), ref[f"{arch}:{dt}:loss"]
    if dt == "float32":
        np.testing.assert_allclose(loss, jloss, rtol=1e-5)
        _grads_close(grads, ref[f"{arch}:{dt}:grads"], 0, 1e-4)
    else:
        np.testing.assert_allclose(loss, jloss, **BF16)
        truth = {k.split(":g:", 1)[1]: v for k, v in got.items()
                 if k.startswith(f"{arch}:{mesh}:float32:g:")}
        _grads_close(grads, ref[f"{arch}:{dt}:grads"], BF16["rtol"],
                     BF16["atol"], truth)


@pytest.mark.parametrize("name", ["seq", "fsdp"])
def test_seq_shard_and_fsdp_dp_give_the_tp_loss(runs, name):
    """internlm2 smoke at 4 × 2 with ``seq_shard=True`` and with
    ``strategy="fsdp_dp"``: the "tp" loss and gradients (float32)."""
    ref, _, got, _, _ = runs
    tp = "internlm2-1.8b:4x2:float32"
    np.testing.assert_allclose(got[f"{name}:loss"], got[tp + ":loss"],
                               rtol=1e-5)
    grads = {k.split(":g:", 1)[1]: v for k, v in got.items()
             if k.startswith(f"{name}:g:")}
    _grads_close(grads, ref["internlm2-1.8b:float32:grads"], 0, 1e-4)


@pytest.mark.parametrize("compress", [False, True])
def test_sharded_adamw_step_matches_jax(runs, compress):
    """``train_step.update`` at 4 × 2 on the drawn gradients from JAX's
    initial state (the clip active: their norm is above 1): the masters,
    mu, nu (and the error state) gathered equal JAX's ``apply_updates``
    (after its ``compress_grads``) within rtol 1e-6."""
    ref, _, got, _, _ = runs
    tag = f"adamw_{compress}"
    assert ref[tag + "_gnorm"] > 1
    np.testing.assert_allclose(got[tag + "_gnorm"], ref[tag + "_gnorm"],
                               rtol=1e-6)
    keys = ("master", "mu", "nu", "err") if compress else ("master", "mu",
                                                           "nu")
    for key in keys:
        want = ref["adamw_err" if key == "err" else f"{tag}_{key}"]
        for name, b in want.items():
            np.testing.assert_allclose(
                got[f"{tag}_{key}:{name}"], b, rtol=1e-6,
                atol=1e-6 * np.abs(b).max(), err_msg=f"{key} {name}")


def test_launcher_matches_jax_driver(runs):
    """``main([... "--model-parallel", "2", "--device", "cpu"])`` on 8 gloo
    ranks (mesh 4 × 2) against JAX's ``main`` on 8 host devices: every
    step's loss within the bf16 tolerance; rank 1 prints nothing."""
    _, jso, got, rank1, _ = runs
    mine, theirs = _losses(str(got["launch"])), _losses(jso)
    assert sorted(mine) == list(range(20)) == sorted(theirs)
    for s in mine:
        np.testing.assert_allclose(mine[s], theirs[s], **BF16,
                                   err_msg=f"step {s}")
    assert mine[19] < mine[0]
    assert all(str(v) == "" for v in rank1.values())


@pytest.mark.parametrize("where", ["mp4", "mp1", "one_rank"])
def test_elastic_restore_continues_the_run(runs, where, tmp_path):
    """The 4 × 2 run's step_10 resumed at 2 × 4, at 8 × 1 and on one rank
    (no mesh): each restores step 10, and its losses of steps 10-19 equal
    the uninterrupted run's within the bf16 tolerance."""
    _, _, got, _, d = runs
    if where == "one_rank":
        run = tmp_path / "one"
        shutil.copytree(d / "run" / "step_10", run / "step_10")
        import contextlib
        import io
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            T.main(LAUNCH + ["--ckpt", str(run), "--resume", "auto"])
        text = buf.getvalue()
    else:
        text = str(got["resume_" + where])
    assert "[resume] restored step 10" in text
    mine, straight = _losses(text), _losses(str(got["launch"]))
    assert sorted(mine) == list(range(10, 20))
    for s in mine:
        np.testing.assert_allclose(mine[s], straight[s], **BF16,
                                   err_msg=f"step {s}")


def test_sharded_checkpoint_is_the_one_device_layout(runs, tmp_path):
    """The 4 × 2 run's step_10 restored into one device's tree and saved by
    ``save_checkpoint``: the same files, byte for byte."""
    _, _, _, _, d = runs
    cfg = get_smoke_config("internlm2-1.8b")
    model = M.init_params(cfg, device="cpu")
    opt, _ = init_train_state(model, TrainConfig())
    like = {"params": dict(model.named_parameters()), "opt": opt}
    tree = restore_checkpoint(str(d / "run"), 10, like)
    save_checkpoint(str(tmp_path), 10, tree)
    a, b = d / "run" / "step_10", tmp_path / "step_10"
    files = sorted(os.listdir(a))
    assert files == sorted(os.listdir(b))
    assert any(f.startswith("opt__master") for f in files)
    for f in files:
        assert (a / f).read_bytes() == (b / f).read_bytes(), f
