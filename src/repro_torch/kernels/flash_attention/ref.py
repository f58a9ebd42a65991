"""Plain PyTorch version of the flash-attention kernel.

q [B, Sq, H, hd] and k/v [B, Sk, KV, hd] with grouped-query heads: query
head h reads KV head ``h // (H // KV)``. Scores and softmax in float32
(scale hd^-0.5). The causal mask is aligned bottom-right: query row i sits
at absolute position ``Sk − Sq + i`` and sees keys ``0 … Sk − Sq + i`` — the
Pallas kernel's mask when Sq == Sk, and the model's ``q_offset``/``kv_len``
mask on a cache sliced to ``kv_len = cache_pos + Sq``. A row that sees no
key gives 0, not NaN. p is cast to v's dtype before the product with v,
which is summed in float32 and rounded once to q's dtype, as the kernel
does.
"""
from __future__ import annotations

import torch


def flash_attention_ref(q, k, v, *, causal: bool = True) -> torch.Tensor:
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (hd ** -0.5)
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
        kpos = torch.arange(Sk, device=q.device)[None, :]
        s = s.masked_fill(kpos > qpos, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)   # fully masked rows
    p = torch.exp(s - m)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    p = p.to(v.dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    return out.reshape(B, Sq, H, hd).to(q.dtype)
