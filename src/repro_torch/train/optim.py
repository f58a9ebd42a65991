"""AdamW with a float32 master copy, global-norm clipping and the LR
schedule: the JAX package's ``train/optim.py``.

The state is (step, mu, nu, master): ``step`` an int32 0-d tensor on the
device, the others dicts from a parameter's name to a float32 tensor
shaped like it (``master`` None without ``keep_master``). The learning
rate and the bias corrections are computed from ``step`` on the device, as
the JAX package computes them from its traced step, so a step reads no
value back to the host.

The update is plain float32 tensor code in the JAX package's order of
operations (``torch.optim.AdamW`` orders them otherwise), applied in
place: mu, nu and the master are updated where they lie, and the
parameter receives ``master.to(param dtype)``. The port stores matmul
weights in bf16 where the JAX package stores float32 and casts at each
use, so the float32 master is where the port keeps the JAX package's
parameters, and the bf16 weight is the value JAX casts to at its next use.
Without ``keep_master`` the update starts from the parameter's own dtype,
as the JAX package's does for bf16 parameters.
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    keep_master: bool = True     # f32 master copy (off → update in param dtype)


class OptState(NamedTuple):
    step: torch.Tensor
    mu: dict
    nu: dict
    master: dict | None


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup → cosine decay to min_lr_frac (float32, on step's
    device)."""
    step = step.float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = ((step - cfg.warmup_steps)
            / max(cfg.total_steps - cfg.warmup_steps, 1)).clamp(0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.minimum(warm, cos)


def init_opt_state(cfg: AdamWConfig, params: dict) -> OptState:
    """Zero moments and, with ``keep_master``, a float32 copy of every
    parameter (never aliasing it), the step 0 on the parameters' device."""
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    master = ({k: p.detach().float().clone() for k, p in params.items()}
              if cfg.keep_master else None)
    dev = next(iter(params.values())).device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev),
                    mu=zeros, nu={k: z.clone() for k, z in zeros.items()},
                    master=master)


def global_norm(tree: dict) -> torch.Tensor:
    """√(Σ over the leaves of Σ x²), each leaf summed in float32."""
    return torch.sqrt(sum(x.float().pow(2).sum() for x in tree.values()))


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params: dict, grads: dict,
                  st: OptState, *, gnorm=None):
    """One AdamW step over ``params`` (name → tensor, updated in place) with
    ``grads`` (name → tensor) → (params, the new state, {"grad_norm",
    "lr"}); the state's mu, nu and master are updated in place. Under a
    mesh the parameters and state are this rank's blocks, and the caller
    passes ``gnorm``, the norm over the logical leaves
    (``parallel.sharding.global_norm``)."""
    step = st.step + 1
    if gnorm is None:
        gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-12),
                        max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for name, p in params.items():
        m, v = st.mu[name], st.nu[name]
        g = grads[name].float() * scale
        m.mul_(cfg.b1).add_(g * (1 - cfg.b1))        # b1·m + (1 − b1)·g
        v.mul_(cfg.b2).add_((g * (1 - cfg.b2)).mul_(g))  # … + (1 − b2)·g·g
        upd = (m / b1c).div_((v / b2c).sqrt_().add_(cfg.eps))
        pf = st.master[name] if cfg.keep_master else p.float()
        pf.sub_(upd.add_(pf * cfg.weight_decay).mul_(lr))
        if pf is not p:
            p.copy_(pf)
    return params, OptState(step=step, mu=st.mu, nu=st.nu,
                            master=st.master), {"grad_norm": gnorm, "lr": lr}
