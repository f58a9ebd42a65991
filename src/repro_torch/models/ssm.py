"""Mamba-2 SSD (state-space duality) block: chunked prefill and O(1)-state
decode.

Ported from the JAX package's ``models/ssm.py``. Per head h, with state
size N and head dim P:
    h_t = exp(dt_t·A) · h_{t-1} + dt_t · B_t ⊗ x_t          (state [N, P])
    y_t = C_t · h_t + D · x_t
in chunked form (chunk Q): an intra-chunk term (C_i·B_j masked by the decay
kernel L_ij) plus an inter-chunk recurrence that carries the state, after
Dao & Gu (arXiv:2405.21060). The JAX package computes both with XLA
einsums and no Pallas kernel, so this module is plain PyTorch.

The activations run in the model's dtype (bf16 on the card) with the
decays, ``dt`` and the intra-chunk kernel in float32, rounded where the JAX
package rounds them: the products of its three-operand einsums are taken
pairwise in the order opt_einsum picks for the shapes (``_pair_first``),
each rounded to the activation dtype, and the inter-chunk state ``h`` stays
in the activation dtype through the recurrence, as ``lax.scan`` keeps it.

Decode keeps one state a layer: the conv window [B, W-1, conv_ch] (the last
W-1 rows before the convolution) and the SSM state h [B, H, N, P], both in
the activation dtype; ``apply_ssm_decode`` writes both in place, so that a
captured decode step advances them. Under a mesh a rank holds its blocks of
both (``parallel.sharding.decode_state_specs``: the conv's channels and h's
heads over "model" where they divide it) and ``apply_ssm_decode`` runs on a
rank's heads, its widths read from the weights it is handed, as
``apply_ssm``'s are (``models/model.py``'s sharded serving moves the conv
window between the two layouts).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers as L


def dims(cfg):
    """(d_inner, SSD heads, conv channels) of ``cfg``."""
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    n_heads = d_inner // s.head_dim
    conv_ch = d_inner + 2 * s.n_groups * s.d_state
    return d_inner, n_heads, conv_ch


class SSM(nn.Module):
    """The weights of one SSD layer, in the JAX package's layout: the input
    projections ``w_z``, ``w_x`` [D, d_inner], ``w_B``, ``w_C`` [D, G·N],
    ``w_dt`` [D, H] and the output projection ``w_out`` [d_inner, D] in the
    activation dtype (the JAX package casts them at every use, which gives
    the same bits); ``dt_bias``, ``A_log``, ``D`` [H], ``conv_w``
    [W, conv_ch] and ``conv_b`` [conv_ch] in float32."""

    MATMUL = ("w_z", "w_x", "w_B", "w_C", "w_dt", "w_out")

    def __init__(self, cfg, dtype, dev):
        super().__init__()
        s, D = cfg.ssm, cfg.d_model
        d_inner, H, conv_ch = dims(cfg)
        GN = s.n_groups * s.d_state
        shapes = dict(w_z=(D, d_inner), w_x=(D, d_inner), w_B=(D, GN),
                      w_C=(D, GN), w_dt=(D, H), dt_bias=(H,), A_log=(H,),
                      D=(H,), conv_w=(s.conv_width, conv_ch),
                      conv_b=(conv_ch,), w_out=(d_inner, D))
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(torch.empty(
                shape, dtype=dtype if name in self.MATMUL else torch.float32,
                device=dev), requires_grad=False))


def ssm_param_specs(cfg, rules) -> dict:
    """The JAX package's specs: w_z, w_x, w_dt, dt_bias, A_log and D cut over
    ``rules.tp`` by heads, w_out row-parallel, w_B, w_C and the conv whole."""
    tp = rules.tp
    return {
        "w_z": (None, tp), "w_x": (None, tp),
        "w_B": (None, None), "w_C": (None, None),
        "w_dt": (None, tp), "dt_bias": (tp,), "A_log": (tp,), "D": (tp,),
        "conv_w": (None, None), "conv_b": (None,),
        "w_out": (tp, None),
    }


def a_log_init(H: int, device=None) -> torch.Tensor:
    """``init_ssm``'s A_log = log(linspace(1, 16, H)) in float32, the
    linspace by ``jnp.linspace``'s formula (start·(1 − t) + stop·t at
    t = i / (H − 1), the last entry ``stop``). XLA's float32 division and
    log on the CPU are not correctly rounded, so the JAX package's values
    may differ from these in the last bits."""
    if H == 1:
        return torch.zeros(1, device=device)
    t = torch.arange(H - 1, dtype=torch.float32, device=device) / (H - 1)
    lin = torch.cat([(1 - t) + 16.0 * t,
                     torch.full((1,), 16.0, device=device)])
    return lin.log()


def _pair_first(first: int, other: int) -> bool:
    """Whether opt_einsum takes the first two operands of one of the SSD's
    three-operand einsums first. The two candidate orders share the large
    contraction and differ in one product: over ``first`` (the extent the
    first pair's own product adds) against one over ``other``; a tie keeps
    the first pair. ``tests/test_torch_ssm.py`` holds this to
    ``jnp.einsum_path``."""
    return first <= other


def _causal_conv(xbc, conv_w, conv_b, state=None):
    """Depthwise causal conv over xbc [B, S, Ch] (W taps, in the activation
    dtype) → (silu(out), the new state: the last W-1 rows of [state; xbc],
    before the convolution)."""
    W = conv_w.shape[0]
    dt = xbc.dtype
    if state is None:
        pad = xbc.new_zeros((xbc.shape[0], W - 1, xbc.shape[2]))
    else:
        pad = state.to(dt)
    xp = torch.cat([pad, xbc], dim=1)
    S = xbc.shape[1]
    out = torch.zeros_like(xbc)
    for w in range(W):
        out = out + xp[:, w:w + S] * conv_w[w].to(dt)
    out = out + conv_b.to(dt)
    return L.silu(out), xp[:, xp.shape[1] - (W - 1):]


def _proj_in(p: SSM, x):
    """z, x, B, C [B, S, ·] in the activation dtype and dt = softplus(x·w_dt
    + dt_bias) [B, S, H] in float32."""
    z = x @ p.w_z
    xin = x @ p.w_x
    Bv = x @ p.w_B
    Cv = x @ p.w_C
    dtv = F.softplus((x @ p.w_dt).float() + p.dt_bias)
    return z, xin, Bv, Cv, dtv


def _split(xbc, d_inner: int, N: int):
    return (xbc[..., :d_inner], xbc[..., d_inner:d_inner + N],
            xbc[..., d_inner + N:])


def apply_ssm(p: SSM, x, cfg, *, return_state: bool = False,
              initial_state=None):
    """Prefill/training forward, chunked SSD. x [B, S, D] → [B, S, D], and
    the final (conv, h) state with ``return_state``. ``initial_state``
    (conv, h) continues from a previous prefill chunk (chunked prefill).
    The widths come from the weights (``w_x``, ``A_log``), so the sharded
    forward passes a rank's heads with the conv cut to its channels."""
    s = cfg.ssm
    B_, S_orig, _ = x.shape
    # the weights' own widths: a rank's heads under a mesh
    d_inner, H = p.w_x.shape[1], p.A_log.shape[0]
    P_, N, Q = s.head_dim, s.d_state, s.chunk
    dt_ = x.dtype

    z, xin, Bv, Cv, dtv = _proj_in(p, x)
    xbc, conv_state = _causal_conv(
        torch.cat([xin, Bv, Cv], dim=-1), p.conv_w, p.conv_b,
        None if initial_state is None else initial_state[0])
    xin, Bv, Cv = _split(xbc, d_inner, N)

    # a ragged prompt is padded to a chunk multiple with dt = 0 (decay
    # exp(0·A) = 1, update dt·B⊗x = 0): the padded tail leaves the state as
    # it was
    pad = (-S_orig) % Q
    if pad:
        xin, Bv, Cv, dtv = (F.pad(t, (0, 0, 0, pad))
                            for t in (xin, Bv, Cv, dtv))
    S = S_orig + pad
    nC = S // Q

    xh = xin.reshape(B_, nC, Q, H, P_)
    Bc = Bv.reshape(B_, nC, Q, N)          # n_groups 1: shared by the heads
    Cc = Cv.reshape(B_, nC, Q, N)
    dtc = dtv.reshape(B_, nC, Q, H)
    A = -torch.exp(p.A_log)                # [H], negative

    a = dtc * A                            # log-decay a step [B, nC, Q, H]
    cum = torch.cumsum(a, dim=2)           # within the chunk
    # intra-chunk: y_i += Σ_{j≤i} (C_i·B_j) exp(cum_i − cum_j) dt_j x_j; the
    # float32 kernel [B, nC, i, j, H]: exp and the product out of place
    # (autograd reads exp's output). The exponent is masked before the exp
    # (exp(−inf) = 0), where the JAX package masks exp's output: the same
    # values, but past j > i the exponent overflows to inf, and its masked
    # gradient, 0 · inf, would be NaN
    Sij = torch.einsum("bcin,bcjn->bcij", Cc, Bc).float()
    future = ~torch.ones(Q, Q, dtype=torch.bool, device=x.device).tril()
    M = (cum[:, :, :, None, :] - cum[:, :, None, :, :]).masked_fill_(
        future[None, None, :, :, None], float("-inf")).exp()
    M = (M * Sij[..., None]).to(dt_)
    del Sij
    xdt = xh * dtc[..., None].to(dt_)      # dt_j x_j
    y_intra = torch.einsum("bcijh,bcjhp->bcihp", M, xdt)
    del M, xdt

    # chunk summaries: the state contribution of chunk c
    w_end = torch.exp(cum[:, :, -1:, :] - cum)     # decay j → chunk end
    wdt = w_end.to(dt_) * dtc.to(dt_)              # [B, nC, Q, H]
    if _pair_first(N, P_):
        wb = wdt[..., :, None] * Bc[..., None, :]  # [B, nC, Q, H, N]
        state_c = torch.einsum("bcjhn,bcjhp->bchnp", wb, xh)
    else:
        wx = wdt[..., None] * xh                   # [B, nC, Q, H, P]
        state_c = torch.einsum("bcjhp,bcjn->bchnp", wx, Bc)
    chunk_decay = torch.exp(a.sum(dim=2)).to(dt_)  # [B, nC, H]

    # inter-chunk recurrence h_c = decay_c · h_{c-1} + state_c, in the
    # activation dtype
    h = (initial_state[1].to(dt_) if initial_state is not None
         else x.new_zeros((B_, H, N, P_)))
    h_prev = []
    for c in range(nC):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + state_c[:, c]
    h_prev = torch.stack(h_prev, dim=1)            # [B, nC, H, N, P]

    # inter-chunk output: C_i · (decay to i) · h_{c-1}
    w_in = torch.exp(cum).to(dt_)                  # decay start → i
    if _pair_first(P_, N):
        ch = torch.einsum("bcin,bchnp->bcihp", Cc, h_prev)
        y_inter = ch * w_in[..., None]
    else:
        cw = Cc[..., :, None] * w_in[..., None, :]  # [B, nC, Q, N, H]
        y_inter = torch.einsum("bcinh,bchnp->bcihp", cw, h_prev)
    y = (y_intra + y_inter).reshape(B_, S, H, P_)
    y = y + xin.reshape(B_, S, H, P_) * p.D.to(dt_)[None, None, :, None]
    y = y.reshape(B_, S, d_inner)[:, :S_orig] * L.silu(z)
    out = y @ p.w_out
    if return_state:
        return out, (conv_state, h)
    return out


def init_ssm_state(cfg, batch: int, dtype, device) -> tuple:
    """A zeroed decode state: (conv [B, W-1, conv_ch], h [B, H, N, P]);
    under a mesh ``models.model.init_decode_state`` makes a rank's blocks
    of them."""
    s = cfg.ssm
    _, H, conv_ch = dims(cfg)
    return (torch.zeros((batch, s.conv_width - 1, conv_ch), dtype=dtype,
                        device=device),
            torch.zeros((batch, H, s.d_state, s.head_dim), dtype=dtype,
                        device=device))


def apply_ssm_decode(p: SSM, x, cfg, state: tuple):
    """One-token decode. x [B, 1, D] → [B, 1, D]; the state (conv, h) is
    advanced in place. The widths come from the weights, as in
    ``apply_ssm``."""
    s = cfg.ssm
    B_ = x.shape[0]
    d_inner, H = p.w_x.shape[1], p.A_log.shape[0]
    P_, N = s.head_dim, s.d_state
    dt_ = x.dtype
    conv, h_state = state

    z, xin, Bv, Cv, dtv = _proj_in(p, x)
    xbc, conv_new = _causal_conv(torch.cat([xin, Bv, Cv], dim=-1),
                                 p.conv_w, p.conv_b, conv)
    xin, Bv, Cv = _split(xbc, d_inner, N)

    xh = xin.reshape(B_, H, P_)
    Bt, Ct, dtt = Bv[:, 0], Cv[:, 0], dtv[:, 0]    # [B, N], [B, N], [B, H]
    dec = torch.exp(dtt * -torch.exp(p.A_log))      # [B, H]
    dtb = dtt.to(dt_)
    if _pair_first(N, P_):
        upd = (dtb[:, :, None] * Bt[:, None, :])[..., None] * xh[:, :, None]
    else:
        upd = (dtb[:, :, None] * xh)[:, :, None, :] * Bt[:, None, :, None]
    h = h_state * dec[:, :, None, None].to(dt_) + upd
    y = torch.einsum("bn,bhnp->bhp", Ct, h)
    y = y + xh * p.D.to(dt_)[None, :, None]
    y = y.reshape(B_, 1, d_inner) * L.silu(z)
    conv.copy_(conv_new)
    h_state.copy_(h)
    return y @ p.w_out
