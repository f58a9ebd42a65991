"""The training step: loss → gradients → (optional int8 compression) →
AdamW, the JAX package's ``train/train_step.py``.

``make_train_step(tcfg)`` returns ``step(model, opt_state, err_state,
batch) → (model, opt_state, err_state, metrics)``: the model's weights and
the optimizer state are updated in place (the JAX package's jitted step
donates them), and the metrics (loss, ce, aux, grad_norm, lr) stay float32
0-d tensors on the device, read by the caller when it wants them. Where
the JAX package's ``make_train_step(cfg, tcfg)`` takes the config, the
port's model carries its own. The gradients are taken with
``torch.autograd.grad`` over the parameters in their module order.

Under a mesh (``parallel.sharding.use_shardings``) the model holds this
rank's blocks (``sharding.shard_model``), the step takes the global batch
and runs on this rank's rows of it (``sharding.batch_rows``), sums the
gradients over the batch axes (``sharding.reduce_grads``: the loss is the
global mean, so each rank's gradient is its rows' share; a leaf whole on
the model ranks whose gradient each computes a part of was summed over the
model group inside the forward's ``copy_to``), compresses them after that
sum as the JAX package compresses GSPMD's reduced gradients, and clips by
the norm over the logical leaves. AdamW's state lives with each rank's
blocks.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import LM, loss_fn, param_specs
from repro_torch.parallel import sharding as SH
from repro_torch.parallel.collectives import (compress_grads,
                                              decompress_grads,
                                              init_error_state)
from repro_torch.train.optim import (AdamWConfig, OptState, apply_updates,
                                     init_opt_state)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    optim: AdamWConfig = AdamWConfig()
    remat: str = "none"            # none | full | dots
    compress_grads: bool = False
    aux_weight: float = 0.01


def make_train_step(tcfg: TrainConfig):
    """Returns step(model, opt_state, err_state, batch) → (model, opt,
    err, metrics)."""

    def step(model: LM, opt_state: OptState, err_state, batch: dict):
        params = dict(model.named_parameters())
        r = SH.current_rules()
        specs = None
        if SH.active(r):
            batch = SH.batch_rows(batch, r)
            specs = param_specs(model.cfg, r)
        loss, parts = loss_fn(model, batch, remat=tcfg.remat,
                              aux_weight=tcfg.aux_weight)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        if specs is not None:
            grads = SH.reduce_grads(grads, specs, r)
        opt_state, err_state, om = update(tcfg, params, grads, opt_state,
                                          err_state, specs)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return model, opt_state, err_state, metrics

    return step


def update(tcfg: TrainConfig, params: dict, grads: dict,
           opt_state: OptState, err_state, specs=None):
    """The step after the gradients (summed over the batch axes): the
    optional compression, then AdamW → (opt_state, err_state, {"grad_norm",
    "lr"}). ``specs`` (under the mesh of ``current_rules()``) make the
    compression's scales and the clip norm those of the logical leaves."""
    mesh = SH.current_mesh() if specs is not None else None
    if tcfg.compress_grads:
        qgrads, err_state = compress_grads(
            grads, err_state,
            None if mesh is None else SH.leaf_max(specs, mesh))
        grads = decompress_grads(qgrads)
    gnorm = None if mesh is None else SH.global_norm(grads, specs, mesh)
    _, opt_state, om = apply_updates(tcfg.optim, params, grads, opt_state,
                                     gnorm=gnorm)
    return opt_state, err_state, om


def init_train_state(model: LM, tcfg: TrainConfig):
    """Turn the model's gradients on (its weights are built without) →
    (the optimizer state, the error-feedback state or None)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = init_opt_state(tcfg.optim, params)
    err = init_error_state(params) if tcfg.compress_grads else None
    return opt, err
