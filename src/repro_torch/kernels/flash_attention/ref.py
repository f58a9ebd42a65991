"""Plain PyTorch version of the flash-attention kernel.

q [B, Sq, H, hd] and k/v [B, Sk, KV, hd] with grouped-query heads: query
head h reads KV head ``h // (H // KV)``. Scores and softmax in float32
(scale hd^-0.5). The causal mask is aligned bottom-right: query row i sits
at absolute position ``Sk − Sq + i`` and sees keys ``0 … Sk − Sq + i`` — the
Pallas kernel's mask when Sq == Sk, and the model's ``q_offset``/``kv_len``
mask on a cache sliced to ``kv_len = cache_pos + Sq``. A row that sees no
key gives 0, not NaN. p is cast to v's dtype before the product with v,
which is summed in float32 and rounded once to q's dtype, as the kernel
does. ``kv_len`` (an int or a 0-d tensor, on any device) masks the keys at
or past it and aligns the causal mask at it — the JAX package's
``_sdpa(q_offset=kv_len − Sq, kv_len=kv_len)``, computed without reading
the value on the host. ``return_lse=True`` also returns each row's
log-sum-exp of the scaled scores, float32 [B, Sq, H]: m + log l of the
row's max m and sum l (−inf for a row that sees no key), the quantity by
which partial attentions over blocks of the keys merge
(``merge_partials_local``).
"""
from __future__ import annotations

import torch


def _lse(m, l):
    """[B, KV, G, Sq] row max and sum → lse [B, Sq, H]: m + log l, −inf
    where l is 0."""
    B, KV, G, Sq = m.shape
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(m, float("-inf")))
    return lse.permute(0, 3, 1, 2).reshape(B, Sq, KV * G)


def flash_attention_ref(q, k, v, *, causal: bool = True,
                        kv_len=None, return_lse: bool = False):
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, Sq, KV, G, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * (hd ** -0.5)
    kpos = torch.arange(Sk, device=q.device)[None, :]
    end = Sk if kv_len is None else torch.as_tensor(kv_len).to(q.device)
    if kv_len is not None:
        s = s.masked_fill(kpos >= end, float("-inf"))
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None] + (end - Sq)
        s = s.masked_fill(kpos > qpos, float("-inf"))
    m = s.amax(dim=-1, keepdim=True).clamp_min(-1e30)   # fully masked rows
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    p = p / l.clamp_min(1e-30)
    p = p.to(v.dtype).float()
    out = torch.einsum("bhgqk,bkhd->bqhgd", p, v.float())
    out = out.reshape(B, Sq, H, hd).to(q.dtype)
    if not return_lse:
        return out
    return out, _lse(m[..., 0], l[..., 0])


def flash_attention_split_ref(q, k, v, *, causal: bool = True, chunk: int,
                              splits: int | None = None,
                              return_lse: bool = False):
    """The split-KV route's own decomposition of the same function: the
    keys in ``splits`` chunks of ``chunk`` (``⌈Sk / chunk⌉`` by default; a
    chunk past Sk is empty). Each chunk gives its row max ``m``, its row sum
    ``l`` and its unnormalised ``o = p·v``, with p taken against the chunk's
    own max and cast to v's dtype; the chunks merge by the log-sum-exp rule
    in float32. A row that sees no key of a chunk gives that chunk m = −inf,
    l = 0, o = 0; a row that sees no key at all gives 0 (and an lse of
    −inf with ``return_lse``)."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    G = H // KV
    if splits is None:
        splits = max(1, -(-Sk // chunk))
    qg = q.reshape(B, Sq, KV, G, hd).float()
    qpos = torch.arange(Sq, device=q.device)[:, None] + (Sk - Sq)
    ms, ls, os_ = [], [], []
    for c in range(splits):
        kc, vc = k[:, c * chunk:(c + 1) * chunk], v[:, c * chunk:(c + 1) * chunk]
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.float()) * (hd ** -0.5)
        if causal:
            kpos = torch.arange(c * chunk, c * chunk + kc.shape[1],
                                device=q.device)[None, :]
            s = s.masked_fill(kpos > qpos, float("-inf"))
        m = (s.amax(dim=-1) if kc.shape[1] else
             s.new_full(s.shape[:-1], float("-inf")))
        p = torch.exp(s - m.clamp_min(-1e30)[..., None])    # 0 where masked
        ls.append(p.sum(dim=-1))
        os_.append(torch.einsum("bhgqk,bkhd->bhgqd", p.to(v.dtype).float(),
                                vc.float()))
        ms.append(m)
    m, l, o = torch.stack(ms), torch.stack(ls), torch.stack(os_)
    mg = m.amax(dim=0)
    w = torch.exp(m - mg.clamp_min(-1e30))                   # 0 from −inf
    lsum = (w * l).sum(dim=0)
    out = (w[..., None] * o).sum(dim=0) / lsum.clamp_min(1e-30)[..., None]
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)
    if not return_lse:
        return out
    return out, _lse(mg, lsum)
