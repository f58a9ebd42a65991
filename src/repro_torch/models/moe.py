"""Mixture-of-experts layer with capacity-based dispatch (Switch style) and
optional shared experts (the DeepSeekMoE recipe).

Ported from the JAX package's ``models/moe.py``, its single-device form:
``capacity``, the weights of ``init_moe`` (the ``MoE`` module; ``model.
init_params`` draws them at ``init_moe``'s scales) and ``apply_moe``.

Dispatch is per sequence: each expert takes at most C = ⌈cf · S · k / E⌉
of a sequence's S·k choices, in the order of (position, rank); the rest
are dropped (their residual passes through). As in the JAX package, the
expert products are dense over the capacity: every expert's weights are
read whatever the routing, and at decode (S 1, C 1) that is every expert
a step. A Switch load-balancing aux loss is returned.

On the card the layer runs without a host sync, so a captured decode step
holds it: the capacity is host arithmetic on shapes, the one-hot is an
elementwise compare, and the dispatch writes each kept slot with a
``scatter_`` — every kept slot receives exactly one token (an expert
appears at most once in a token's top-k), so the bits repeat, with no
``index_add_`` atomics; only the overflow bin ``E·C``, which is dropped,
receives several.

The expert-parallel forms of the JAX package (``apply_moe_shardmap``,
``apply_moe_a2a``) wait for the port's sharding rules (ROADMAP.md queue 1).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L


def capacity(S: int, m) -> int:
    """Slots per expert for a sequence of S tokens: ⌈cf · S · k / E⌉, at
    least 1."""
    return max(1, math.ceil(m.capacity_factor * S * m.top_k / m.n_experts))


def _param(shape, dtype, dev) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=dev),
                        requires_grad=False)


class MoE(nn.Module):
    """The weights of one MoE layer, in the JAX package's layout: the
    router [D, E] in float32 (the JAX package routes in float32, and a
    bf16 router flips top-k choices), the experts' ``wup``/``wgate``
    [E, D, F] and ``wdown`` [E, F, D] in the activation dtype, and, with
    ``n_shared``, ``shared``: a SwiGLU MLP of width ``n_shared · F``."""

    def __init__(self, d_model: int, m, dtype, dev):
        super().__init__()
        E, D, Fe = m.n_experts, d_model, m.d_expert
        self.router = _param((D, E), torch.float32, dev)
        self.wup = _param((E, D, Fe), dtype, dev)
        self.wgate = _param((E, D, Fe), dtype, dev)
        self.wdown = _param((E, Fe, D), dtype, dev)
        self.shared = None
        if m.n_shared:
            F_sh = m.n_shared * Fe
            self.shared = nn.ParameterDict({
                "wup": _param((D, F_sh), dtype, dev),
                "wgate": _param((D, F_sh), dtype, dev),
                "wdown": _param((F_sh, D), dtype, dev)})


def route(p: MoE, x, m):
    """The router: (probs [B, S, E] float32, gates [B, S, k] renormalised,
    expert indices [B, S, k]) of x [B, S, D]."""
    logits = x.float() @ p.router
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.topk(probs, m.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    return probs, gate_vals, expert_idx


def dispatch_slots(expert_idx, E: int, C: int):
    """(keep, slot) [B, S·k] of expert indices [B, S, k]: a choice's
    position within its expert is the number of choices of that expert
    before it in its sequence, over (position, rank); it is kept below C,
    at slot ``e·C + position``, else sent to the overflow bin ``E·C``."""
    B, S, k = expert_idx.shape
    flat_e = expert_idx.reshape(B, S * k)
    # [B, E, S·k]: the running count is a scan along the innermost axis
    # (the card's scan along an outer axis was the prefill's longest kernel)
    onehot = (torch.arange(E, device=flat_e.device)[:, None]
              == flat_e[:, None, :]).to(torch.int32)
    before = torch.cumsum(onehot, dim=-1, dtype=torch.int32) - onehot
    pos = before.gather(1, flat_e[:, None, :])[:, 0]
    keep = pos < C
    return keep, torch.where(keep, flat_e * C + pos, E * C)


def apply_moe(p: MoE, x, m, activation: str = "swiglu"):
    """x [B, S, D] → (y [B, S, D], aux loss float32 scalar)."""
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    C = capacity(S, m)
    dt = x.dtype
    probs, gate_vals, expert_idx = route(p, x, m)

    # Switch LB loss: E · Σ_e f_e · P_e, f_e the share of choices of e
    onehot = expert_idx[..., None] == torch.arange(E, device=x.device)
    f = onehot.sum(dim=2).float().mean(dim=1)                  # [B, E]
    aux = E * (f * probs.mean(dim=1)).sum(dim=-1).mean()
    keep, slot = dispatch_slots(expert_idx, E, C)

    # dispatch: each kept slot of [B, E·C+1, D] gets its one token
    idx = slot[..., None].expand(B, S * k, D)
    xk = x[:, :, None, :].expand(B, S, k, D).reshape(B, S * k, D)
    buf = x.new_zeros((B, E * C + 1, D)).scatter_(1, idx, xk)
    buf = buf[:, :E * C].reshape(B, E, C, D).transpose(0, 1)
    buf = buf.reshape(E, B * C, D)

    # the experts: a grouped product over E
    up = torch.bmm(buf, p.wup)
    gate = torch.bmm(buf, p.wgate)
    h = (L.silu(gate) if activation == "swiglu"
         else F.gelu(gate, approximate="tanh")) * up
    out = torch.bmm(h, p.wdown).reshape(E, B, C, D).transpose(0, 1)
    flat_out = x.new_zeros((B, E * C + 1, D))
    flat_out[:, :E * C] = out.reshape(B, E * C, D)

    # combine: each token's k slots, weighted by its gates (a dropped
    # choice reads the zero row and weighs 0)
    gathered = flat_out.gather(1, idx).reshape(B * S, k, D)
    w = torch.where(keep.reshape(B, S, k), gate_vals, 0.0).to(dt)
    y = torch.bmm(w.reshape(B * S, 1, k), gathered).reshape(B, S, D)

    if p.shared is not None:
        y = y + L.apply_mlp(p.shared, x, "swiglu")
    return y, aux
