"""One training step of the port against the JAX package's, on a
registered model's smoke config: the case that ``test_torch_train_grads``
(float32) and ``test_torch_train_grads_bf16`` share.

The JAX side runs, in one ``jax.jit``, ``jax.value_and_grad`` of its
``loss_fn`` and one step of its ``make_train_step`` from ``init_train_state``
(float32 masters of its float32 params). The port's side gets the same
weights through ``convert.lm_params`` and the same optimizer state through
``convert.opt_state``, then its own ``loss_fn`` with ``torch.autograd.grad``
and one step of its ``make_train_step``. The batch is the JAX package's
``batch_at`` (B 2 × S 64, labels of sequence 0's first 3 positions set to
-1 so the mask is exercised) with its ``extra_inputs`` (64 frames, 32
patches), handed to the port as the same bits.

Both packages' ``apply_updates`` also take JAX's gradients from JAX's
initial state (``replay`` and ``jax_replay``: masters, mu and nu), which
holds the optimizer on one step of a real model's gradients apart from the
noise between the two packages' gradients.

MoE routing: every MoE layer call's router probabilities are recorded on
the JAX side (a ``jax.debug.callback`` in a wrapped ``apply_moe``, as
``test_torch_lm.py``'s ``routing`` fixture does), and the port's router
follows JAX's top-k expert choices (``moe.route`` wrapped: the port's own
probabilities, gathered at JAX's indices and renormalised as ``route``
renormalises, so the router's gradient is the port's own). The port's own
choices are recorded too: they must equal JAX's on every token whose JAX
k-th/(k+1)-th margin is at least the dtype's ROUTE_MARGIN (0 in float32:
every token), and the flips below it are counted.

The JAX package's SSD gradient is NaN (``ClampedExpNumpy``): for the SSM
and hybrid models the reference is its own ``value_and_grad`` with the
exp of ``repro.models.ssm`` clamped, which changes no forward value.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
import repro.models.model as jax_model
import repro.models.moe as jax_moe
import repro.models.ssm as jax_ssm
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.train import AdamWConfig as JaxAdamWConfig
from repro.train import DataConfig as JaxDataConfig
from repro.train import TrainConfig as JaxTrainConfig
from repro.train import batch_at as jax_batch_at
from repro.train import extra_inputs as jax_extra_inputs
from repro.train import init_train_state as jax_init_train_state
from repro.train import make_train_step as jax_make_train_step
from repro.train.optim import apply_updates as jax_apply_updates
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import model as M
from repro_torch.models import moe as port_moe
from repro_torch.train import (AdamWConfig, TrainConfig, apply_updates,
                               init_train_state, make_train_step)

ARCHS = ("internlm2-1.8b", "starcoder2-7b", "starcoder2-15b", "gemma-2b",
         "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-1.3b",
         "jamba-v0.1-52b", "seamless-m4t-medium", "internvl2-76b")
B, S = 2, 64
OPTIM = dict(lr=3e-4, warmup_steps=5, total_steps=30)
ROUTE_MARGIN = {"float32": 0.0, "bfloat16": 0.02}


def _np(x):
    return np.asarray(x.detach().float().numpy()
                      if isinstance(x, torch.Tensor) else x, np.float32)


def _batches(cfg):
    """(JAX's batch, the port's): the JAX package's data, the same bits."""
    jb = jax_batch_at(JaxDataConfig(vocab=cfg.vocab, seq_len=S,
                                    global_batch=B), 0)
    labels = np.array(jb["labels"])
    labels[0, :3] = -1
    jb["labels"] = jnp.asarray(labels)
    jb.update(jax_extra_inputs(cfg, B, S))
    tb = {}
    for k, a in jb.items():
        if a.dtype == jnp.bfloat16:
            tb[k] = torch.from_numpy(np.array(a, np.float32)).bfloat16()
        else:
            tb[k] = torch.from_numpy(np.array(a))
    return jb, tb


class ClampedExpNumpy:
    """``jax.numpy`` with ``exp(x)`` taken as ``exp(min(x, 80))``, for
    ``repro.models.ssm``: the JAX package's SSD gradient is NaN. Its
    intra-chunk kernel is ``jnp.where(causal, jnp.exp(decay), 0)``, and
    past the diagonal ``decay`` (a sum of −dt·A ≥ 0) overflows exp to inf,
    so the masked cotangent meets 0 · inf. Every exponent the module takes
    elsewhere is ≤ 0 (decays, −exp(A_log) with A_log ≤ log 16), so the
    clamp changes no forward value and leaves JAX's gradient finite: it is
    the reference for the port's, which masks the exponent instead
    (``test_ssd_reference_gradient_is_nan_and_the_ports_finite``)."""

    def __getattr__(self, name):
        return getattr(jnp, name)

    @staticmethod
    def exp(x):
        return jnp.exp(jnp.minimum(x, 80.0))


def _top_k(probs, k):
    """``jax.lax.top_k``'s indices of numpy probabilities (descending, ties
    to the lower index)."""
    return np.argsort(-probs, axis=-1, kind="stable")[..., :k]


def run_case(arch: str, dtype: str) -> dict:
    """Both sides' loss, parts, gradients (the JAX ones by the port's
    parameter names), step metrics and optimizer states after one step,
    and the routing record; in bf16 also ``float32_grads``, the port's
    float32 gradients of the same weights, batch and routes."""
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    cfg = jax_get_smoke_config(arch)
    jax_rec = []
    jax_apply = jax_moe.apply_moe

    def recorded_apply(p, x, m, activation="swiglu"):
        probs = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", x.astype(jnp.float32), p["router"]), axis=-1)
        jax.debug.callback(lambda a: jax_rec.append(np.asarray(a)), probs,
                           ordered=True)
        return jax_apply(p, x, m, activation)

    jtcfg = JaxTrainConfig(optim=JaxAdamWConfig(**OPTIM))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_layers, "ACT_DTYPE", jdt)
        mp.setattr(jax_model, "ACT", jdt)
        mp.setattr(jax_moe, "apply_moe", recorded_apply)
        mp.setattr(jax_ssm, "jnp", ClampedExpNumpy())
        params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
        jopt, _ = jax_init_train_state(cfg, jtcfg, params)
        jb, tb = _batches(cfg)
        vg = jax.value_and_grad(
            lambda p, b: jax_model.loss_fn(p, cfg, b), has_aux=True)
        step = jax_make_train_step(cfg, jtcfg)
        np_opt = jax.tree.map(np.asarray, jopt)
        ((jloss, jparts), jgrads), (_, jopt2, _, jmetrics) = jax.jit(
            lambda p, o, b: (vg(p, b), step(p, o, None, b)))(params, jopt, jb)
        jax.effects_barrier()
        _, jreplay, _ = jax.jit(lambda p, g, o: jax_apply_updates(
            jtcfg.optim, p, g, o))(params, jgrads, jopt)

    model = convert.lm_params(jax.tree.map(np.asarray, params),
                              get_smoke_config(arch), device="cpu",
                              dtype=getattr(torch, dtype))
    tcfg = TrainConfig(optim=AdamWConfig(**OPTIM))
    init_train_state(model, tcfg)
    opt = convert.opt_state(np_opt, model, device="cpu")
    np_grads = convert.lm_leaves(jax.tree.map(np.asarray, jgrads), model)
    _, replay, _ = apply_updates(
        tcfg.optim, {k: p.detach().clone()
                     for k, p in model.named_parameters()},
        {k: torch.from_numpy(np.asarray(g, np.float32))
         for k, g in np_grads.items()},
        convert.opt_state(np_opt, model, device="cpu"))
    n_moe = sum(layer.moe is not None for layer in model.layers)
    if n_moe:               # one record of each call by each of the two
        assert len(jax_rec) == 2 * n_moe   # forwards in the jitted program
        for a, b in zip(jax_rec[:n_moe], jax_rec[n_moe:]):
            np.testing.assert_array_equal(a, b)
    k = cfg.moe.top_k if cfg.moe else 0
    jax_idx = [_top_k(a, k) for a in jax_rec[:n_moe]]
    port_rec = []
    port_route = port_moe.route

    def following_route(p, x, m):
        probs, _, own = port_route(p, x, m)
        i = len(port_rec) % n_moe
        port_rec.append((probs.detach().numpy(), own.numpy()))
        idx = torch.from_numpy(jax_idx[i]).long()
        gates = probs.gather(-1, idx)
        return probs, gates / gates.sum(-1, keepdim=True).clamp_min(1e-9), idx

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(port_moe, "route", following_route)
        params_t = dict(model.named_parameters())
        loss, parts = M.loss_fn(model, tb)
        grads = dict(zip(params_t, torch.autograd.grad(
            loss, list(params_t.values()))))
        _, opt2, _, metrics = make_train_step(tcfg)(model, opt, None, tb)
        truth = None
        if dtype != "float32":      # the same function in float32
            model32 = convert.lm_params(jax.tree.map(np.asarray, params),
                                        get_smoke_config(arch), device="cpu",
                                        dtype=torch.float32)
            model32.requires_grad_(True)
            p32 = dict(model32.named_parameters())
            loss32, _ = M.loss_fn(model32, tb)
            truth = dict(zip(p32, torch.autograd.grad(
                loss32, list(p32.values()))))

    flips, margin = 0, ROUTE_MARGIN[dtype]
    for a, (_, own) in zip(jax_rec[:n_moe], port_rec[:n_moe]):
        srt = -np.sort(-a, axis=-1)
        gap = srt[..., k - 1] - srt[..., k]
        flip = (np.sort(_top_k(a, k), -1) != np.sort(own, -1)).any(-1)
        assert not (flip & (gap >= margin)).any(), (gap[flip], margin)
        flips += int(flip.sum())
    return dict(
        cfg=cfg, model=model, params=dict(model.named_parameters()),
        loss=loss.detach(), parts={k: v.detach() for k, v in parts.items()},
        grads=grads, float32_grads=truth, metrics=metrics, opt=opt2,
        jax_loss=jloss, jax_parts=jparts,
        jax_grads=np_grads, replay=replay,
        jax_replay={key: convert.lm_leaves(
            jax.tree.map(np.asarray, getattr(jreplay, key)), model)
            for key in ("master", "mu", "nu")},
        jax_metrics=jmetrics,
        jax_master=convert.lm_leaves(jax.tree.map(np.asarray, jopt2.master),
                                     model),
        jax_step=int(jopt2.step), flips=flips, moe_calls=n_moe,
        lr1=float(jmetrics["lr"]), optim=tcfg.optim)


def assert_grads_close(grads, jax_grads, rtol, atol):
    """Every leaf within rtol·|JAX| + atol·max|JAX leaf|; a leaf that JAX
    gives exactly zero is zero on the port's side too."""
    assert set(grads) == set(jax_grads)
    for name, g in grads.items():
        a, b = _np(g), np.asarray(jax_grads[name], np.float32)
        scale = np.abs(b).max()
        if scale == 0:
            assert np.abs(a).max() == 0, name
            continue
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol * scale,
                                   err_msg=name)


def assert_adamw_replay_matches_jax(case, tol):
    """The port's ``apply_updates`` on JAX's gradients from JAX's initial
    state: masters, mu and nu within ``tol`` × the JAX leaf's largest
    |value| of JAX's ``apply_updates`` on the same."""
    for key, leaves in case["jax_replay"].items():
        got = getattr(case["replay"], key)
        assert set(got) == set(leaves), key
        for name, b in leaves.items():
            b = np.asarray(b, np.float32)
            np.testing.assert_allclose(_np(got[name]), b, rtol=0,
                                       atol=tol * np.abs(b).max(),
                                       err_msg=f"{key} {name}")
