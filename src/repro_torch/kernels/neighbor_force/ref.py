"""Plain PyTorch version of the k-hop neighbor-list repulsion.

``nbr_idx[n, K]`` holds up to K neighbor indices per vertex (sentinel = n);
the gather uses (n+1)-row padded position/weight tables so sentinel slots
contribute zero force. An index is resolved as the JAX package's gather
resolves it (``resolve_slots``). Row-chunked so the [rows, K, 2] gather
stays bounded.
"""
from __future__ import annotations

import torch


def resolve_slots(idx: torch.Tensor, n: int) -> torch.Tensor:
    """The row of the (n+1)-row tables that each index reads, as JAX's
    gather reads it: a negative index gets n+1 added, then every index is
    clamped to [0, n]. Row n is the zero sentinel; row 0 is a real vertex,
    so an index below −(n+1) reads vertex 0."""
    idx = idx.long()
    return torch.where(idx < 0, idx + (n + 1), idx).clamp_(0, n)


def neighbor_repulsion_ref(pos, mass, nbr_idx, nbr_mask, vmask,
                           cl2: float, md2: float, *,
                           chunk_elems: int = 1 << 24) -> torch.Tensor:
    n, K = nbr_idx.shape
    w = torch.where(vmask, mass, 0.0)
    pos_p = torch.cat([pos, pos.new_zeros((1, 2))])
    w_p = torch.cat([w, w.new_zeros((1,))])
    out = pos.new_empty((n, 2))
    step = max(1, chunk_elems // max(K, 1))
    for i in range(0, n, step):
        idx = resolve_slots(nbr_idx[i:i + step], n)
        npos = pos_p[idx]                                  # [rows, K, 2]
        nw = torch.where(nbr_mask[i:i + step], w_p[idx], 0.0)
        delta = pos[i:i + step, None, :] - npos
        d2 = delta[..., 0] * delta[..., 0] + delta[..., 1] * delta[..., 1] + md2
        inv = (cl2 * nw) / d2
        out[i:i + step] = (delta * inv[..., None]).sum(dim=1)
    return torch.where(vmask[:, None], out, 0.0)


def neighbor_repulsion_lanes_ref(pos, mass, nbr_idx, nbr_mask, vmask,
                                 consts) -> torch.Tensor:
    """B independent lanes (every argument with a leading lane axis, indices
    local to their lane; consts [B, 2] = (C·L², md²) of each lane) →
    [B, n, 2]; lane b is ``neighbor_repulsion_ref`` of lane b alone."""
    return torch.stack([neighbor_repulsion_ref(
        pos[b], mass[b], nbr_idx[b], nbr_mask[b], vmask[b], consts[b, 0],
        consts[b, 1]) for b in range(pos.shape[0])])
