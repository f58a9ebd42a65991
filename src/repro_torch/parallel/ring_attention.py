"""Ring attention (context parallelism): sequence-cut exact attention, the
JAX package's ``parallel/ring_attention.py``.

The sequence is cut over an axis of the mesh; each rank keeps its block of
queries and the KV blocks rotate around the ring (``comm.ppermute``), each
arriving block folded into a streaming softmax in float32 (running max and
denominator). Causality is by global positions: a block wholly in a query's
future contributes exp(−inf) = 0, and the schedule keeps the same steps.
Forward only, as in the JAX package, whose test does not differentiate it.
A one-rank axis attends over its own block and sends nothing. Its merge
streams (max, sum, an unnormalised accumulator in v's dtype) one block at
a time in the JAX package's order; ``comm.merge_partials`` combines
normalised partials by their log-sum-exp in float32 instead, so sharing it
would move this module's bf16 roundings away from the JAX package's.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import comm


def ring_attention(mesh, *, axis: str = "model", causal: bool = True,
                   batch_axes=("data",)):
    """→ f(q, k, v): this rank's blocks q [B_loc, S_loc, H, hd], k/v
    [B_loc, S_loc, KV, hd] (B cut over ``batch_axes``, S over ``axis``) →
    its block of exact (GQA) attention [B_loc, S_loc, H, hd]. The scores
    are taken in the inputs' dtype and scaled there, then the softmax
    streams in float32 and the accumulator stays in v's dtype, in the JAX
    package's order."""
    group = mesh.group(axis)
    size = mesh.shape[axis]
    perm = [(i, (i + 1) % size) for i in range(size)]

    @torch.no_grad()
    def f(q, k, v):
        B, Sq, H, hd = q.shape
        Sk, KV = k.shape[1], k.shape[2]
        G = H // KV
        idx = mesh.axis_index(axis)
        scale = hd ** -0.5
        # [B, KV, G·Sq, hd]: query head h = kv·G + g reads KV head kv
        qg = q.reshape(B, Sq, KV, G, hd).permute(0, 2, 3, 1, 4).reshape(
            B, KV, G * Sq, hd)
        qpos = idx * Sq + torch.arange(Sq, device=q.device)
        m = torch.full((B, KV, G * Sq), float("-inf"), device=q.device)
        l = torch.zeros((B, KV, G * Sq), device=q.device)
        acc = torch.zeros((B, KV, G * Sq, hd), dtype=v.dtype,
                          device=q.device)
        kb, vb = k, v
        for s in range(size):
            src = (idx - s) % size          # whose block this rank holds
            sc = (qg @ kb.permute(0, 2, 3, 1) * scale).float()
            if causal:
                kpos = src * Sk + torch.arange(Sk, device=q.device)
                future = (qpos[:, None] < kpos[None, :]).repeat(G, 1)
                sc = sc.masked_fill(future, float("-inf"))
            m_new = torch.maximum(m, sc.amax(-1))
            shift = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(sc - shift[..., None])
            corr = torch.where(torch.isfinite(m), torch.exp(m - shift), 0.0)
            l = l * corr + p.sum(-1)
            pv = p.to(vb.dtype) @ vb.permute(0, 2, 1, 3)
            acc = acc * corr[..., None].to(acc.dtype) + pv
            m = m_new
            if s + 1 < size:                # the next rank's block
                kb = comm.ppermute(kb, group, perm)
                vb = comm.ppermute(vb, group, perm)
        out = acc / l.clamp_min(1e-30)[..., None].to(acc.dtype)
        return out.reshape(B, KV, G, Sq, hd).permute(0, 3, 1, 2, 4).reshape(
            B, Sq, H, hd)

    return f
