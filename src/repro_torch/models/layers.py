"""Transformer layer library: norms, RoPE, GQA attention, gated MLPs.

Functions of tensors, ported from the JAX package's ``models/layers.py``;
the modules that hold the weights are in ``model.py``. Activations run in
the model's dtype (bf16 by default) with float32 softmax, norm and RoPE
internals, and SiLU rounded at JAX's steps (``silu``). Matmul weights are stored once in the activation dtype: the JAX
package stores float32 and casts at every use, which gives the same bits.
Norm scales stay float32. The JAX package's sharding constraints have no
counterpart here: under a mesh ``model.py``'s sharded forward hands these
functions each rank's blocks of the weights and makes each layout change
itself (``attention_param_specs`` and ``mlp_param_specs`` say how the
weights are cut). Cross-attention
(the encoder-decoder family) is ``apply_attention(cross_kv=...)`` with the
keys and values from ``cross_kv``: no RoPE on either side, no mask.
Training attends through ``train_attention`` (``apply_attention(train=
True)``): the flash kernel has no backward, as the JAX package's Pallas
kernel has none; the JAX model trains through XLA's ``_sdpa``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import flash_attention_ref


# -- norms ---------------------------------------------------------------------

NORM_EPS = 1e-6


def apply_norm(p, x, kind: str):
    """p: "scale" (and "bias" for layernorm), float32 [D]."""
    xf = x.float()
    if kind == "rmsnorm":
        var = (xf * xf).mean(dim=-1, keepdim=True)
        out = xf * torch.rsqrt(var + NORM_EPS) * p["scale"]
    else:
        mu = xf.mean(dim=-1, keepdim=True)
        var = xf.var(dim=-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + NORM_EPS) * p["scale"] + p["bias"]
    return out.to(x.dtype)


# -- rotary position embeddings -------------------------------------------------

def rope_angles(positions, head_dim: int, theta: float):
    """positions int[..., S] → (cos, sin) [..., S, head_dim//2] float32."""
    half = head_dim // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                   device=positions.device) / half)
    ang = positions.float()[..., None] * freq
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x [..., S, H, hd]; cos/sin broadcastable [..., S, 1, hd//2]."""
    half = x.shape[-1] // 2
    xf1, xf2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([xf1 * cos - xf2 * sin, xf2 * cos + xf1 * sin],
                     dim=-1).to(x.dtype)


# -- attention -------------------------------------------------------------------

def _proj(x, w):
    """x [B, S, D] · w [D, *rest] → [B, S, *rest] (the einsum
    ``bsd,d...->bs...`` as one matmul on a view of w)."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(*x.shape[:2],
                                                    *w.shape[1:])


def rope_for(positions, cfg):
    """(cos, sin) [S, 1, hd//2] of positions int [S] (one row for the whole
    batch). Every layer uses the same angles, so the model computes them
    once per call where the JAX package computes them in each layer."""
    cos, sin = rope_angles(positions, cfg.hd, cfg.rope_theta)
    return cos[:, None, :], sin[:, None, :]


def _qkv(p, x, rope):
    """p: wq [D,H,hd], wk/wv [D,KV,hd]; rope from ``rope_for`` → q [B,S,H,hd],
    k/v [B,S,KV,hd] with RoPE on q and k."""
    q = _proj(x, p["wq"])
    k = _proj(x, p["wk"])
    v = _proj(x, p["wv"])
    return apply_rope(q, *rope), apply_rope(k, *rope), v


def sdpa_attention(q, k, v, *, causal: bool):
    """q [B, S, H, hd], k/v [B, Sk, KV, hd] → [B, S, H, hd] through
    ``F.scaled_dot_product_attention`` on [B, heads, S, hd] views: query
    head h reads KV head ``h // (H // KV)`` (``enable_gqa``), scale
    hd^-½, and a causal mask only where Sq == Sk, where SDPA's top-left
    mask is the plain version's bottom-right one."""
    if causal and q.shape[1] != k.shape[1]:
        raise ValueError(f"sdpa_attention: causal with Sq {q.shape[1]} != "
                         f"Sk {k.shape[1]}")
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=causal, enable_gqa=q.shape[2] != k.shape[2])
    return out.transpose(1, 2)


def train_attention(q, k, v, *, causal: bool):
    """The training route, differentiable on both devices: on the card
    ``sdpa_attention`` (the counterpart of the JAX package's ``_sdpa``,
    which its training differentiates), on the CPU the plain
    ``flash_attention_ref`` through autograd."""
    if q.device.type == "cuda":
        return sdpa_attention(q, k, v, causal=causal)
    return flash_attention_ref(q, k, v, causal=causal)


def apply_attention(p, x, rope, *, causal=True, cache=None, cache_pos=None,
                    cross_kv=None, train=False):
    """Attention block (``causal=False``: the encoder's self-attention).
    ``cache`` = (k, v) [B, Smax, KV, hd] for prefill/decode, written in
    place at ``cache_pos``; the JAX package updates it functionally and
    returns it. ``cross_kv`` = (k, v) [B, S_enc, KV, hd] from ``cross_kv``:
    cross-attention, q = x·wq with no RoPE (``rope`` is not read) against
    every frame, with no mask, no cache and no ``kv_len``. The JAX
    package's ``_sdpa`` becomes the flash-attention kernel:

    * ``cache_pos`` an int (prefill): the new rows are written by a slice
      and attention reads ``cache[:, :kv_len]`` with the causal mask
      aligned bottom-right — ``_sdpa``'s ``q_offset``/``kv_len`` mask;
    * ``cache_pos`` an int32 0-d tensor on the device (decode, one new
      row): the row is written by ``index_copy_`` at it and attention reads
      the whole cache with ``kv_len = cache_pos + 1`` on the device, so no
      host value changes from step to step.

    ``train`` (no cache) attends through ``train_attention`` instead."""
    attend = train_attention if train else flash_attention
    if cross_kv is not None:
        out = attend(_proj(x, p["wq"]), *cross_kv, causal=False)
    elif cache is not None:
        q, k_new, v_new = _qkv(p, x, rope)
        ck, cv = cache
        if isinstance(cache_pos, torch.Tensor):
            at = cache_pos.reshape(1).long()
            ck.index_copy_(1, at, k_new)
            cv.index_copy_(1, at, v_new)
            out = flash_attention(q, ck, cv, causal=True,
                                  kv_len=cache_pos + x.shape[1])
        else:
            kv_len = cache_pos + x.shape[1]
            ck[:, cache_pos:kv_len] = k_new
            cv[:, cache_pos:kv_len] = v_new
            out = flash_attention(q, ck[:, :kv_len], cv[:, :kv_len],
                                  causal=True)
    else:
        q, k, v = _qkv(p, x, rope)
        out = attend(q, k, v, causal=causal)
    wo = p["wo"]                                    # [H, hd, D]
    return out.reshape(*out.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


def cross_kv(p, enc_out):
    """The cross-attention's keys and values [B, S_enc, KV, hd] of the
    encoder output ``enc_out`` [B, S_enc, D]: enc_out·wk and enc_out·wv,
    with no RoPE."""
    return _proj(enc_out, p["wk"]), _proj(enc_out, p["wv"])


def attention_param_specs(cfg, rules) -> dict:
    """The JAX package's specs of wq/wk/wv/wo: heads over ``rules.heads``,
    KV heads over ``rules.kv_heads``."""
    h, kv = rules.heads, rules.kv_heads
    return {"wq": (None, h, None), "wk": (None, kv, None),
            "wv": (None, kv, None), "wo": (h, None, None)}


# -- MLP -------------------------------------------------------------------------

def mlp_param_specs(activation: str, rules) -> dict:
    """Column-parallel wup/wgate, row-parallel wdown over ``rules.tp``."""
    tp = rules.tp
    p = {"wup": (None, tp), "wdown": (tp, None)}
    if activation in ("swiglu", "geglu"):
        p["wgate"] = (None, tp)
    return p


def silu(x):
    """``jax.nn.silu`` as XLA computes it: x · 1/(1 + exp(−x)), each step
    rounded to x's dtype. ``F.silu`` rounds once, which in bf16 differs
    from it in ~40% of values (by an ulp): over a 4-layer hybrid model
    that moved logits past the bf16 tolerance against the JAX package.
    Four elementwise launches where ``F.silu`` takes one."""
    return x * (1 / (1 + torch.exp(-x)))


def apply_mlp(p, x, activation: str):
    up = x @ p["wup"]
    if activation == "swiglu":
        h = silu(x @ p["wgate"]) * up
    elif activation == "geglu":
        h = F.gelu(x @ p["wgate"], approximate="tanh") * up
    else:
        h = F.gelu(up, approximate="tanh")
    return h @ p["wdown"]


# -- embeddings -------------------------------------------------------------------

def apply_embedding(p, tokens):
    return p["tok"][tokens]


def apply_lm_head(p_embed, p_head, x, tie: bool):
    if tie:
        return x @ p_embed["tok"].t()
    return x @ p_head["w"]
