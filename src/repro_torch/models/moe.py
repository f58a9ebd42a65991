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

Under a mesh (``parallel.sharding.current_rules()``) each rank holds its
blocks of the weights (``moe_param_specs``). ``apply_moe`` then runs the
form the rules give: EP (``rules.experts``: the rank's E / model experts)
or TP inside every expert (``rules.expert_tp``: the rank's columns of each
expert's FFN); the router runs whole on every model rank, the rank's part
of the experts on ``copy_to`` of the tokens and gates, and the parts are
summed by ``psum`` over the model group. ``apply_moe_shardmap`` is the EP
form by name (the JAX package's explicit ``shard_map``), ``apply_moe_a2a``
the DeepSpeed-MoE form, whose tokens travel to their expert's rank by
``all_to_all`` over the model group and back. Each keeps the ``scatter_``
dispatch: every kept slot receives one row.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import active, current_rules


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


def moe_param_specs(m, rules) -> dict:
    """The JAX package's specs: the experts cut over ``rules.experts``
    (EP) or each expert's FFN over ``rules.expert_tp``; the router whole;
    the shared experts as an MLP."""
    if rules.experts:                    # EP
        w = wd = (rules.experts, None, None)
    else:                                # TP inside experts
        w = (None, None, rules.expert_tp)
        wd = (None, rules.expert_tp, None)
    specs = {"router": (None, None), "wup": w, "wgate": w, "wdown": wd}
    if m.n_shared:
        specs.update({f"shared.{k}": v for k, v in
                      L.mlp_param_specs("swiglu", rules).items()})
    return specs


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


def _aux(probs, expert_idx, E: int):
    """Switch LB loss: E · Σ_e f_e · P_e, f_e the share of choices of e."""
    onehot = expert_idx[..., None] == torch.arange(E, device=probs.device)
    f = onehot.sum(dim=2).float().mean(dim=1)                  # [B, E]
    return E * (f * probs.mean(dim=1)).sum(dim=-1).mean()


def _dispatch(x, slot, n_slots: int):
    """[B, n_slots + 1, D]: row ``slot[b, i]`` of batch b holds x's row
    ``i // k`` (x [B, S, D], slot [B, S·k]); slot ``n_slots`` is the
    overflow bin. Each slot below it must receive at most one row."""
    B, S, D = x.shape
    k = slot.shape[1] // S
    idx = slot[..., None].expand(B, S * k, D)
    xk = x[:, :, None, :].expand(B, S, k, D).reshape(B, S * k, D)
    return x.new_zeros((B, n_slots + 1, D)).scatter_(1, idx, xk), idx


def _experts(p: MoE, buf, activation: str):
    """The experts' FFN on buf [E', N, D] — a grouped product over E'."""
    up = torch.bmm(buf, p.wup)
    gate = torch.bmm(buf, p.wgate)
    h = (L.silu(gate) if activation == "swiglu"
         else F.gelu(gate, approximate="tanh")) * up
    return torch.bmm(h, p.wdown)


def _moe(p: MoE, x, m, activation: str, group=None, e0: int = 0,
         E_loc: int | None = None, f32_sum: bool = False):
    """The MoE layer, whole (``group`` None) or this rank's part over the
    model ``group``: experts [e0, e0 + E_loc) of E with the weights' own
    FFN width; its output summed over the group (in float32, rounded once,
    with ``f32_sum``: sharded serving's)."""
    B, S, D = x.shape
    E, k = m.n_experts, m.top_k
    E_loc = E if E_loc is None else E_loc
    C = capacity(S, m)
    dt = x.dtype
    probs, gate_vals, expert_idx = route(p, x, m)
    aux = _aux(probs, expert_idx, E)
    keep, slot = dispatch_slots(expert_idx, E, C)
    if group is not None:
        x = comm.copy_to(x, group)
        gate_vals = comm.copy_to(gate_vals, group)
    if E_loc != E:                       # this rank's experts only
        e = expert_idx.reshape(B, S * k)
        keep = keep & (e >= e0) & (e < e0 + E_loc)
        slot = torch.where(keep, slot - e0 * C, E_loc * C)

    # dispatch: each kept slot of [B, E·C+1, D] gets its one token
    buf, idx = _dispatch(x, slot, E_loc * C)
    buf = buf[:, :E_loc * C].reshape(B, E_loc, C, D).transpose(0, 1)
    out = _experts(p, buf.reshape(E_loc, B * C, D), activation)
    out = out.reshape(E_loc, B, C, D).transpose(0, 1)
    flat_out = x.new_zeros((B, E_loc * C + 1, D))
    flat_out[:, :E_loc * C] = out.reshape(B, E_loc * C, D)

    # combine: each token's k slots, weighted by its gates (a dropped
    # choice reads the zero row and weighs 0)
    gathered = flat_out.gather(1, idx).reshape(B * S, k, D)
    w = torch.where(keep.reshape(B, S, k), gate_vals, 0.0).to(dt)
    y = torch.bmm(w.reshape(B * S, 1, k), gathered).reshape(B, S, D)

    if p.shared is not None:
        y = y + L.apply_mlp(p.shared, x, "swiglu")
    if group is not None:
        y = (comm.psum(y.float(), group).to(y.dtype) if f32_sum
             else comm.psum(y, group))
    return y, aux


def apply_moe(p: MoE, x, m, activation: str = "swiglu", *,
              f32_sum: bool = False):
    """x [B, S, D] → (y [B, S, D], aux loss float32 scalar). Under a mesh
    whose rules cut the experts (EP) or inside them (``expert_tp``): this
    rank's part, x whole over the model group."""
    r = current_rules()
    if active(r) and r.experts:
        return apply_moe_shardmap(p, x, m, activation, f32_sum=f32_sum)
    if active(r) and r.expert_tp:
        return _moe(p, x, m, activation, r.mesh.model_group,
                    f32_sum=f32_sum)
    return _moe(p, x, m, activation)


def apply_moe_shardmap(p: MoE, x, m, activation: str = "swiglu", *,
                       f32_sum: bool = False):
    """EP over the model axis (the JAX package's explicit ``shard_map``
    form): x [B_loc, S, D] is whole over the model group, the rank holds
    experts [i·E/model, (i+1)·E/model), routes every token (the router is
    whole), fills the dispatch buffer of its own experts alone, and the
    partial outputs are summed over the model group — one all-reduce of
    [B_loc, S, D]. On a one-rank group it is ``apply_moe``'s arithmetic."""
    mesh = current_rules().mesh
    msize = mesh.shape["model"]
    E_loc = m.n_experts // msize
    return _moe(p, x, m, activation, mesh.model_group,
                mesh.axis_index("model") * E_loc, E_loc, f32_sum)


def apply_moe_a2a(p: MoE, x, m, activation: str = "swiglu"):
    """EP via all-to-all (DeepSpeed-MoE): the tokens are cut over the model
    axis too (``rules.batch`` holds it: strategy ``fsdp_dp``). Each rank
    routes its own rows, sends each choice to the rank that owns its expert
    (at most C_pair = ⌈cf·S·k / model⌉ rows to each peer, the rest
    dropped), packs what it receives into its experts' buffers of C_big =
    ⌈cf · model · C_pair / E_loc⌉ slots, runs them, and the outputs return
    by the reverse all-to-all to be combined at their source — the JAX
    package's capacities and drops. The local expert id travels as one
    more column of the payload, as in the JAX package."""
    r = current_rules()
    if "model" not in (r.batch or ()):
        raise ValueError("apply_moe_a2a cuts the tokens over the model "
                         f"axis: rules.batch {r.batch} lacks it (strategy "
                         "fsdp_dp)")
    mesh = r.mesh
    g = mesh.model_group
    E, k = m.n_experts, m.top_k
    msize = mesh.shape["model"]
    E_loc = E // msize
    B, S, D = x.shape
    dt = x.dtype
    C_pair = max(1, math.ceil(m.capacity_factor * S * k / msize))
    C_big = max(1, math.ceil(m.capacity_factor * msize * C_pair / E_loc))

    probs, gate_vals, expert_idx = route(p, x, m)
    aux = _aux(probs, expert_idx, E)
    # destination rank + slot within the [dest, C_pair] send buffer
    flat_e = expert_idx.reshape(B, S * k)
    keep, slot = dispatch_slots((flat_e // E_loc)[..., None], msize, C_pair)
    send, idx = _dispatch(x, slot, msize * C_pair)
    meta = torch.where(keep, flat_e % E_loc + 1, 0).to(dt)
    meta = torch.zeros((B, msize * C_pair + 1), dtype=dt, device=x.device
                       ).scatter_(1, slot, meta)
    payload = torch.cat([send, meta[..., None]], dim=-1)[:, :msize * C_pair]
    recv = comm.all_to_all(payload.reshape(B, msize, C_pair, D + 1), g, 1)
    rx = recv[..., :D].reshape(B, msize * C_pair, D)
    e_loc = recv[..., D].float().round().long().reshape(B, msize * C_pair) - 1

    # pack into the local expert buffer [E_loc, C_big, D]
    valid = e_loc >= 0
    ekeep, eslot = dispatch_slots(
        torch.where(valid, e_loc, E_loc)[..., None], E_loc + 1, C_big)
    ekeep = ekeep & valid
    eslot = torch.where(ekeep, eslot, E_loc * C_big)
    buf, eidx = _dispatch(rx, eslot, E_loc * C_big)
    buf = buf[:, :E_loc * C_big].reshape(B, E_loc, C_big, D).transpose(0, 1)
    out = _experts(p, buf.reshape(E_loc, B * C_big, D), activation)
    out = out.reshape(E_loc, B, C_big, D).transpose(0, 1)
    flat_out = x.new_zeros((B, E_loc * C_big + 1, D))
    flat_out[:, :E_loc * C_big] = out.reshape(B, E_loc * C_big, D)

    # unpack to the receive layout, reverse all-to-all, combine at the source
    back = flat_out.gather(1, eidx).reshape(B, msize, C_pair, D)
    ret = comm.all_to_all(back, g, 1).reshape(B, msize * C_pair, D)
    ret = torch.cat([ret, x.new_zeros((B, 1, D))], dim=1)
    got = ret.gather(1, idx).reshape(B * S, k, D)
    w = torch.where(keep.reshape(B, S, k), gate_vals, 0.0).to(dt)
    y = torch.bmm(w.reshape(B * S, 1, k), got).reshape(B, S, D)
    if p.shared is not None:
        y = y + L.apply_mlp(p.shared, x, "swiglu")
    return y, aux
