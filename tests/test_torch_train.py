"""The port's optimizer, data stream, gradient compression, checkpoints and
training driver on the CPU, against the JAX package's where it has the same
function.

Tolerances:
- ``lr_at`` and ``global_norm``: rtol 1e-6 (float32; XLA and torch take
  cos, sqrt and the sums in their own way, one or two ulps);
- ``apply_updates`` over 3 steps on equal gradients (float32 params and
  masters): rtol 1e-6, atol 1e-9 (the same float32 expression; XLA fuses
  multiply-adds, so the last bit may differ);
- ``batch_at``, ``extra_inputs`` and the int8 compression with its error
  feedback: bit for bit;
- the driver: JAX's own thresholds (``tests/test_system.py``: loss < 6.0
  after 30 smoke steps, resumed run within 0.5 of it); a run stopped at
  step 20 and resumed equals the uninterrupted run bit for bit (loss,
  weights and optimizer state).
"""
import os
import shutil

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from torch_threads import one_torch_thread  # noqa: F401 (autouse)

import repro.train.data as jax_data
import repro.train.optim as jax_optim
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.parallel import collectives as jax_coll
from repro_torch.ckpt import (CheckpointManager, latest_step,
                              restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_smoke_config
from repro_torch.launch.train import main
from repro_torch.parallel import collectives as coll
from repro_torch.train import data, optim


# -- optimizer ------------------------------------------------------------------

def test_lr_at_matches_jax_warmup_boundary_and_tail():
    cfg = optim.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    jcfg = jax_optim.AdamWConfig(lr=3e-4, warmup_steps=10, total_steps=100,
                                 min_lr_frac=0.1)
    steps = [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]
    got = [float(optim.lr_at(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in steps]
    want = [float(jax_optim.lr_at(jcfg, jnp.asarray(s, jnp.int32)))
            for s in steps]
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0] == 0.0 and got[4] == pytest.approx(3e-4)
    assert got[-1] == pytest.approx(3e-5)      # the floor past total_steps


def _tree(seed, shapes, dtype=np.float32):
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) * 0.5).astype(dtype)
            for k, s in shapes.items()}


SHAPES = {"a": (7, 5), "b": (13,), "c": (3, 4, 2)}


def test_global_norm_matches_jax():
    t = _tree(0, SHAPES)
    got = optim.global_norm({k: torch.from_numpy(v) for k, v in t.items()})
    np.testing.assert_allclose(float(got), float(jax_optim.global_norm(
        {k: jnp.asarray(v) for k, v in t.items()})), rtol=1e-6)


@pytest.mark.parametrize("keep_master", [True, False])
@pytest.mark.parametrize("clip", [1.0, 1e3])
def test_apply_updates_matches_jax_over_three_steps(keep_master, clip):
    """Three steps from equal params and equal gradients: params, mu, nu,
    master, grad_norm and lr; clipping on (norm 1, the gradients' norm is
    ~7) and off; the float32 master kept or not."""
    kw = dict(lr=1e-2, warmup_steps=2, total_steps=10, clip_norm=clip,
              keep_master=keep_master)
    cfg, jcfg = optim.AdamWConfig(**kw), jax_optim.AdamWConfig(**kw)
    p0 = _tree(1, SHAPES)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    jparams = {k: jnp.asarray(v) for k, v in p0.items()}
    st, jst = optim.init_opt_state(cfg, params), jax_optim.init_opt_state(
        jcfg, jparams)
    assert st.step.dtype == torch.int32 and (st.master is None) != keep_master
    for i in range(3):
        g = _tree(10 + i, SHAPES)
        params, st, m = optim.apply_updates(
            cfg, params, {k: torch.from_numpy(v) for k, v in g.items()}, st)
        jparams, jst, jm = jax_optim.apply_updates(
            jcfg, jparams, {k: jnp.asarray(v) for k, v in g.items()}, jst)
        assert int(st.step) == int(jst.step) == i + 1
        for key in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]),
                                       rtol=1e-6)
        trees = [(params, jparams), (st.mu, jst.mu), (st.nu, jst.nu)]
        if keep_master:
            trees.append((st.master, jst.master))
        for mine, theirs in trees:
            for k in SHAPES:
                np.testing.assert_allclose(mine[k].numpy(),
                                           np.asarray(theirs[k]),
                                           rtol=1e-6, atol=1e-9)
    if clip == 1.0:
        assert float(m["grad_norm"]) > clip


def test_apply_updates_bf16_params_take_the_cast_master():
    cfg = optim.AdamWConfig(lr=1e-2, warmup_steps=1)
    p = {"w": torch.randn(64, generator=torch.Generator().manual_seed(0))
         .bfloat16()}
    st = optim.init_opt_state(cfg, p)
    _, st, _ = optim.apply_updates(cfg, p, {"w": torch.ones(64)}, st)
    assert p["w"].dtype == torch.bfloat16
    assert torch.equal(p["w"], st.master["w"].bfloat16())


# -- data -----------------------------------------------------------------------

@pytest.mark.parametrize("seed,step,host_id,n_hosts", [
    (0, 0, 0, 1), (0, 17, 0, 1), (3, 5, 1, 2), (7, 2, 3, 4)])
def test_batch_at_equals_jax_bit_for_bit(seed, step, host_id, n_hosts):
    cfg = data.DataConfig(vocab=1000, seq_len=130, global_batch=8, seed=seed)
    jcfg = jax_data.DataConfig(vocab=1000, seq_len=130, global_batch=8,
                               seed=seed)
    got = data.batch_at(cfg, step, host_id=host_id, n_hosts=n_hosts)
    want = jax_data.batch_at(jcfg, step, host_id=host_id, n_hosts=n_hosts)
    for k in ("tokens", "labels"):
        assert got[k].dtype == torch.int32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("arch,seq", [("seamless-m4t-medium", 48),
                                      ("internvl2-76b", 40),
                                      ("internvl2-76b", 1024),
                                      ("internlm2-1.8b", 64)])
def test_extra_inputs_equal_jax_bit_for_bit(arch, seq):
    """Frames and patches: the same bf16 bits (JAX rounds float64 to
    float32 to bf16 with 64-bit mode off)."""
    got = data.extra_inputs(get_smoke_config(arch), 3, seq, seed=5)
    want = jax_data.extra_inputs(jax_get_smoke_config(arch), 3, seq, seed=5)
    assert set(got) == set(want)
    for k, a in want.items():
        assert got[k].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            got[k].view(torch.int16).numpy(),
            np.asarray(a).view(np.int16))


# -- int8 compression -----------------------------------------------------------

def test_int8_compression_and_error_feedback_equal_jax():
    """Three steps of compress → decompress with the error carried: q,
    scales, the decompressed gradients and the error state, bit for bit."""
    err = coll.init_error_state({k: torch.zeros(s) for k, s in
                                 SHAPES.items()})
    jerr = jax_coll.init_error_state({k: jnp.zeros(s) for k, s in
                                      SHAPES.items()})
    for i in range(3):
        g = _tree(20 + i, SHAPES)
        g["b"][3] = 0.0
        q, err = coll.compress_grads(
            {k: torch.from_numpy(v) for k, v in g.items()}, err)
        jq, jerr = jax_coll.compress_grads(
            {k: jnp.asarray(v) for k, v in g.items()}, jerr)
        deq, jdeq = coll.decompress_grads(q), jax_coll.decompress_grads(jq)
        for k in SHAPES:
            assert q[k][0].dtype == torch.int8
            np.testing.assert_array_equal(q[k][0].numpy(),
                                          np.asarray(jq[k][0]))
            assert float(q[k][1]) == float(jq[k][1])
            np.testing.assert_array_equal(deq[k].numpy(),
                                          np.asarray(jdeq[k]))
            np.testing.assert_array_equal(err[k].numpy(),
                                          np.asarray(jerr[k]))
    q0, s0 = coll.quantize_int8(torch.zeros(4))
    assert float(s0) == pytest.approx(1e-12 / 127) and not q0.any()


# -- checkpoints ----------------------------------------------------------------

def _ckpt_tree():
    opt = optim.init_opt_state(optim.AdamWConfig(), {
        "w": torch.arange(6, dtype=torch.float32).reshape(2, 3)})
    return {"a": torch.arange(10, dtype=torch.float32),
            "b": {"c": (torch.arange(12).reshape(3, 4) / 7).bfloat16()},
            "opt": opt._replace(step=torch.tensor(5, dtype=torch.int32))}


def test_checkpoint_roundtrip_bf16_and_named_tuples(tmp_path):
    tree = _ckpt_tree()
    save_checkpoint(str(tmp_path), 7, tree)
    assert latest_step(str(tmp_path)) == 7
    assert np.load(os.path.join(tmp_path, "step_7", "b__c.npy")).dtype == \
        np.dtype("V2")                   # the JAX package's bf16 leaves
    like = {"a": torch.zeros(10), "b": {"c": torch.zeros(3, 4).bfloat16()},
            "opt": optim.init_opt_state(optim.AdamWConfig(),
                                        {"w": torch.zeros(2, 3)})}
    back = restore_checkpoint(str(tmp_path), 7, like)
    assert back["b"]["c"].dtype == torch.bfloat16
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    assert torch.equal(back["a"], tree["a"])
    assert isinstance(back["opt"], optim.OptState)
    assert back["opt"].step.dtype == torch.int32 and int(back["opt"].step) == 5
    assert torch.equal(back["opt"].master["w"], tree["opt"].master["w"])


def test_checkpoint_corruption_detected_and_skipped(tmp_path):
    tree = {"a": torch.arange(16, dtype=torch.float32)}
    mgr = CheckpointManager(str(tmp_path), keep=5)
    mgr.save_async(1, tree)
    mgr.save_async(2, {"a": tree["a"] + 1})
    mgr.wait()
    with open(os.path.join(str(tmp_path), "step_2", "a.npy"), "wb") as f:
        f.write(b"garbage")
    step, back = mgr.restore_latest(tree)
    assert step == 1
    assert torch.equal(back["a"], torch.arange(16, dtype=torch.float32))
    assert not os.path.exists(os.path.join(str(tmp_path), "step_2"))
    mgr.close()


def test_partial_tmp_checkpoint_ignored(tmp_path):
    save_checkpoint(str(tmp_path), 3, {"a": torch.zeros(4)})
    os.makedirs(os.path.join(str(tmp_path), "step_9.tmp"))
    assert latest_step(str(tmp_path)) == 3


def test_manager_keeps_the_newest_k(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 6):
        mgr.save_async(s, {"a": torch.full((3,), float(s))})
    mgr.wait()
    mgr.close()
    assert sorted(os.listdir(tmp_path)) == ["step_4", "step_5"]


def test_save_async_snapshots_before_an_in_place_update(tmp_path):
    """The optimizer updates in place right after a save: the checkpoint
    holds the values at the save (a CPU tensor's ``.cpu()`` is itself)."""
    w = torch.arange(1000, dtype=torch.float32)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    mgr.close()
    back = restore_checkpoint(str(tmp_path), 1, {"w": torch.zeros(1000)})
    assert torch.equal(back["w"], torch.arange(1000, dtype=torch.float32))


# -- the driver -----------------------------------------------------------------

SMOKE = ["--smoke", "--seq", "128", "--batch", "4", "--log-every", "100",
         "--device", "cpu"]


def test_train_loss_descends_and_resumes(tmp_path):
    """JAX's ``test_train_loss_descends_and_resumes`` on the port."""
    ckpt = str(tmp_path / "run")
    loss1 = main(["--arch", "gemma-2b", "--steps", "30", "--ckpt", ckpt,
                  "--ckpt-every", "15", *SMOKE])
    assert loss1 < 6.0   # init loss ≈ log(512) ≈ 6.2
    loss2 = main(["--arch", "gemma-2b", "--steps", "40", "--ckpt", ckpt,
                  "--resume", "auto", *SMOKE])
    assert loss2 < loss1 + 0.5


def test_train_with_compression_descends():
    loss = main(["--arch", "internlm2-1.8b", "--steps", "30",
                 "--compress-grads", *SMOKE])
    assert loss < 6.0


def test_resumed_run_equals_uninterrupted_bit_for_bit(tmp_path, capsys):
    """40 steps straight against 40 steps checkpointed every 20, step_40
    deleted and resumed from step 20: the same final loss and the same
    weights and optimizer state in the final checkpoints, bit for bit."""
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    args = ["--arch", "internlm2-1.8b", "--steps", "40", *SMOKE]
    loss_a = main([*args, "--ckpt", a, "--ckpt-every", "100"])
    main([*args, "--ckpt", b, "--ckpt-every", "20"])
    assert sorted(os.listdir(b)) == ["step_20", "step_40"]
    shutil.rmtree(os.path.join(b, "step_40"))
    loss_b = main([*args, "--ckpt", b, "--resume", "auto"])
    assert "[resume] restored step 20" in capsys.readouterr().out
    assert loss_b == loss_a
    files = sorted(os.listdir(os.path.join(a, "step_40")))
    assert files == sorted(os.listdir(os.path.join(b, "step_40")))
    assert any(f.startswith("opt__master") for f in files)
    for f in files:
        if f.endswith(".npy"):
            x, y = (np.load(os.path.join(d, "step_40", f)) for d in (a, b))
            assert x.tobytes() == y.tobytes(), f
