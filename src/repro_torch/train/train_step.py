"""The training step: loss → gradients → (optional int8 compression) →
AdamW, the JAX package's ``train/train_step.py`` on one device.

``make_train_step(tcfg)`` returns ``step(model, opt_state, err_state,
batch) → (model, opt_state, err_state, metrics)``: the model's weights and
the optimizer state are updated in place (the JAX package's jitted step
donates them), and the metrics (loss, ce, aux, grad_norm, lr) stay float32
0-d tensors on the device, read by the caller when it wants them. Where
the JAX package's ``make_train_step(cfg, tcfg)`` takes the config, the
port's model carries its own. The gradients are taken with
``torch.autograd.grad`` over the parameters in their module order.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.model import LM, loss_fn
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
        loss, parts = loss_fn(model, batch, remat=tcfg.remat,
                              aux_weight=tcfg.aux_weight)
        grads = dict(zip(params, torch.autograd.grad(loss,
                                                     list(params.values()))))
        if tcfg.compress_grads:
            qgrads, err_state = compress_grads(grads, err_state)
            grads = decompress_grads(qgrads)
        _, opt_state, om = apply_updates(tcfg.optim, params, grads,
                                         opt_state)
        metrics = {"loss": loss.detach(),
                   **{k: v.detach() for k, v in parts.items()}, **om}
        return model, opt_state, err_state, metrics

    return step


def init_train_state(model: LM, tcfg: TrainConfig):
    """Turn the model's gradients on (its weights are built without) →
    (the optimizer state, the error-feedback state or None)."""
    model.requires_grad_(True)
    params = dict(model.named_parameters())
    opt = init_opt_state(tcfg.optim, params)
    err = init_error_state(params) if tcfg.compress_grads else None
    return opt, err
