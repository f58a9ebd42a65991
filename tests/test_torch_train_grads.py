"""The port's training path against the JAX package's on the CPU, in
float32: ``loss_fn``, every gradient leaf and one ``make_train_step`` step
(``torch_train_cases.run_case``: state carried by ``convert``, MoE routes
following JAX's), for every registered model's smoke config; the remat
modes; the card route's SDPA mapping, held on the CPU.

Tolerances (float32; the JAX side switched to float32 by patching
``repro.models.layers.ACT_DTYPE`` and ``repro.models.model.ACT``):
- loss, ce, aux, grad_norm, lr: rtol = atol = 1e-4 (the same float32
  function, sums in another order; measured |Δloss| ≤ 1.5e-6);
- each gradient leaf: rtol 1e-4, atol 1e-4 × the leaf's largest |JAX
  value| (measured ≤ 6.4e-6 of it);
- the float32 masters after one step: atol 0.25 × the step's lr, rtol
  1e-6. At step 1 Adam moves an element by lr · g/(|g| + eps), eps 1e-8,
  whose slope at g = 0 is lr/eps: an element whose gradient lies within a
  few eps of zero moves by up to 0.1·lr for float32 noise of 1e-9 in it
  (measured: 0.073·lr on seamless-m4t-medium, ≤ 0.018·lr elsewhere). The
  optimizer's arithmetic itself is held tightly on equal gradients in
  ``test_torch_train.py``, and here on JAX's gradients of each model: the
  port's ``apply_updates`` from JAX's state gives JAX's masters, mu and
  nu within 1e-5 × the leaf's largest |JAX value| (the grad norm's sum
  order moves the clip scale by ~5e-7, nu by twice that);
- remat: on the CPU every mode gives the same loss and gradients bit for
  bit (the same ops recomputed);
- SDPA against the plain flash attention: rtol = atol = 1e-5 in value and
  gradient (float32; sums in another order).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch_threads import one_torch_thread  # noqa: F401 (autouse)
from torch_train_cases import (ARCHS, _batches, _np,
                               assert_adamw_replay_matches_jax,
                               assert_grads_close, run_case)

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
import repro.models.model as jax_model
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro_torch import convert

from repro_torch.configs import get_smoke_config
from repro_torch.kernels.flash_attention.ref import flash_attention_ref
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.train import batch_at, DataConfig, extra_inputs

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    return run_case(request.param, "float32")


def test_loss_matches_jax(case):
    np.testing.assert_allclose(float(case["loss"]), float(case["jax_loss"]),
                               **TOL)
    for part in ("ce", "aux"):
        np.testing.assert_allclose(float(case["parts"][part]),
                                   float(case["jax_parts"][part]), **TOL)
    assert case["flips"] == 0          # float32: every choice is JAX's


def test_ssd_reference_gradient_is_nan_and_the_ports_finite():
    """The JAX package's SSD gradient is NaN on the training data
    (``torch_train_cases.ClampedExpNumpy`` says why); the port's, which
    masks the exponent before the exp, is finite and its forward equal."""
    cfg = jax_get_smoke_config("mamba2-1.3b")
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    jb, tb = _batches(cfg)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "ACT_DTYPE", jnp.float32)
        mp.setattr(jax_model, "ACT", jnp.float32)
        (jloss, _), jgrads = jax.jit(jax.value_and_grad(
            lambda p, b: jax_model.loss_fn(p, cfg, b), has_aux=True))(
                params, jb)
    assert np.isnan(np.asarray(jgrads["groups"][0]["ssm"]["w_x"])).any()
    model = convert.lm_params(jax.tree.map(np.asarray, params),
                              get_smoke_config("mamba2-1.3b"), device="cpu",
                              dtype=torch.float32)
    model.requires_grad_(True)
    loss, _ = M.loss_fn(model, tb)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), **TOL)
    for g in torch.autograd.grad(loss, list(model.parameters())):
        assert torch.isfinite(g).all()


def test_grads_match_jax(case):
    assert_grads_close(case["grads"], case["jax_grads"], **TOL)


def test_grads_reach_attention_and_router(case):
    """wq, wk, wv (self- and cross-attention) and the MoE router receive a
    gradient: nonzero, and JAX's."""
    names = [n for n in case["grads"]
             if n.rsplit(".", 1)[-1] in ("wq", "wk", "wv", "router")]
    cfg = case["cfg"]
    assert names or cfg.family == "ssm"
    if cfg.moe is not None:
        assert any(n.endswith("router") for n in names)
    for n in names:
        assert float(case["grads"][n].abs().max()) > 0, n
    assert_grads_close({n: case["grads"][n] for n in names},
                       {n: case["jax_grads"][n] for n in names}, **TOL)


def test_train_step_matches_jax(case):
    m, jm = case["metrics"], case["jax_metrics"]
    for key in ("loss", "ce", "aux", "grad_norm", "lr"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), **TOL,
                                   err_msg=key)
    opt = case["opt"]
    assert int(opt.step) == case["jax_step"] == 1
    assert opt.step.dtype == torch.int32
    for name, p in case["params"].items():
        master = opt.master[name]
        np.testing.assert_allclose(_np(master), case["jax_master"][name],
                                   rtol=1e-6, atol=0.25 * case["lr1"],
                                   err_msg=name)
        assert torch.equal(p.detach(), master.to(p.dtype)), name


def test_adamw_on_jax_grads_matches_jax(case):
    assert_adamw_replay_matches_jax(case, 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_give_the_same_loss_and_grads(arch):
    """``forward(remat=)``: "full" and "dots" give "none"'s loss and
    gradients bit for bit on the CPU, each group rematerialised."""
    cfg = get_smoke_config(arch)
    model = M.init_params(cfg, seed=2, device="cpu", dtype=torch.float32)
    model.requires_grad_(True)
    batch = batch_at(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=2),
                     3)
    batch.update(extra_inputs(cfg, 2, 32))
    params = list(model.parameters())
    out = {}
    for remat in M.REMAT:
        loss, _ = M.loss_fn(model, batch, remat=remat)
        out[remat] = (loss, torch.autograd.grad(loss, params))
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], out["none"][0]), remat
        for a, b in zip(out[remat][1], out["none"][1]):
            assert torch.equal(a, b), remat
    with pytest.raises(ValueError):
        M.forward(model, batch, remat="some")


SDPA_CASES = [  # (H, KV, Sq, Sk, causal)
    (4, 4, 24, 24, True), (6, 2, 24, 24, True), (8, 1, 17, 17, True),
    (6, 3, 24, 40, False), (4, 4, 9, 9, False)]


@pytest.mark.parametrize("H,KV,Sq,Sk,causal", SDPA_CASES)
def test_sdpa_route_matches_plain_in_value_and_grad(H, KV, Sq, Sk, causal):
    """The card's training route (``layers.sdpa_attention``: GQA by
    ``enable_gqa``, causal where Sq == Sk, cross-attention non-causal over
    Sk ≠ Sq) run on the CPU against the plain ``flash_attention_ref``, the
    CPU's route: the outputs and the gradients of q, k and v."""
    g = torch.Generator().manual_seed(H * 100 + Sk)
    q = torch.randn(2, Sq, H, 16, generator=g, requires_grad=True)
    k = torch.randn(2, Sk, KV, 16, generator=g, requires_grad=True)
    v = torch.randn(2, Sk, KV, 16, generator=g, requires_grad=True)
    w = torch.randn(2, Sq, H, 16, generator=g)
    outs = []
    for fn in (L.sdpa_attention, flash_attention_ref):
        o = fn(q, k, v, causal=causal)
        outs.append((o, torch.autograd.grad((o * w).sum(), (q, k, v))))
    (o1, g1), (o2, g2) = outs
    torch.testing.assert_close(o1, o2, rtol=1e-5, atol=1e-5)
    for a, b in zip(g1, g2):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert L.train_attention(q, k, v, causal=causal).grad_fn is not None
    if causal:
        with pytest.raises(ValueError):
            L.sdpa_attention(q, k[:, :-1], v[:, :-1], causal=True)
