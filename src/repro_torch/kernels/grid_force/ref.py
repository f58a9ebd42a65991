"""Plain PyTorch versions of the grid-force kernels.

``grid_near_ref`` gathers each cell's bucket rows and the 9·cap slots of its
3×3 neighborhood exactly as the JAX package's ``grid_repulsion`` does before
its near kernel (empty slots: position 0, weight 0), computes the same force
law, and scatters each bucketed vertex's force into ``f_near[n, 2]``.
``grid_far_ref`` is every vertex against every cell aggregate, row-chunked:
at n = 2^20 against 16384 cells the pair matrix must never be materialised.
``near_field_ref`` is the near field a row at a time (the sharded grid
step's form): each row a vertex against the slots of its 9 cells, gathered
exactly as the JAX package's ``_grid_rep_spmd`` gathers them for its near
kernel, in row chunks.
``cl2 = C·L·L`` and ``md2 = md·md`` arrive float32-rounded
(``kernels._build.force_consts``).
"""
from __future__ import annotations

import torch

from repro_torch.kernels.nbody.ref import two_set_ref


def grid_near_ref(pos, mass, vmask, bucket, table, cl2: float, md2: float, *,
                  chunk_elems: int = 1 << 24) -> torch.Tensor:
    """pos f32[n, 2]; bucket int32[nc+1, cap] (sentinel n); table
    int32[nc+1, 9] (sentinel nc) → f_near f32[n, 2] (0 outside buckets)."""
    n = pos.shape[0]
    nc, cap = bucket.shape[0] - 1, bucket.shape[1]
    w = torch.where(vmask, mass, 0.0)
    pos_p = torch.cat([pos, pos.new_zeros((1, 2))])
    w_p = torch.cat([w, w.new_zeros((1,))])
    bucket_l = bucket.long()
    table_l = table.long()
    f_near = pos.new_zeros((n + 1, 2))
    step = max(1, chunk_elems // (9 * cap * cap))
    for c0 in range(0, nc, step):
        rows_idx = bucket_l[c0:c0 + step]                          # [R, cap]
        nbr = bucket_l[table_l[c0:c0 + step]].reshape(-1, 9 * cap)  # [R, 9cap]
        rows_pos = pos_p[rows_idx]
        nbr_pos = pos_p[nbr]
        cw = cl2 * w_p[nbr]
        dx = rows_pos[:, :, 0:1] - nbr_pos[:, None, :, 0]
        dy = rows_pos[:, :, 1:2] - nbr_pos[:, None, :, 1]
        d2 = dx * dx + dy * dy + md2
        inv = cw[:, None, :] / d2
        near = torch.stack([(dx * inv).sum(dim=2), (dy * inv).sum(dim=2)],
                           dim=2)
        f_near[rows_idx.reshape(-1)] = near.reshape(-1, 2)
    return f_near[:n]


def near_field_ref(rows, near9, cells, cl2, md2, *, pos=None, w=None,
                   col0: int = 0, ncols: int | None = None,
                   chunk_elems: int = 1 << 24) -> torch.Tensor:
    """rows f32[R, 2] against columns [col0, col0 + ncols) of the 9·cap
    slots of their cells ``near9`` int32[R, 9] → f32[R, 2]; ``cells`` is
    int32[ncell, cap] of indices into ``pos`` f32[N, 2] / ``w`` f32[N]
    (index form) or f32[ncell, cap, 3] = (x, y, w) (direct form). Columns
    past 9·cap add 0."""
    R, cap = rows.shape[0], cells.shape[1]
    K = 9 * cap
    k1 = min(K, col0 + (K - col0 if ncols is None else ncols))
    out = rows.new_zeros((R, 2))
    if k1 <= col0:
        return out
    step = max(1, chunk_elems // (k1 - col0))
    for r0 in range(0, R, step):
        n9 = near9[r0:r0 + step].long()
        if pos is not None:
            idx = cells.long()[n9].reshape(-1, K)[:, col0:k1]
            px, pw = pos[idx], w[idx]
        else:
            e = cells[n9].reshape(-1, K, 3)[:, col0:k1]
            px, pw = e[..., :2], e[..., 2]
        r = rows[r0:r0 + step]
        dx = r[:, 0:1] - px[..., 0]
        dy = r[:, 1:2] - px[..., 1]
        d2 = dx * dx + dy * dy + md2
        inv = cl2 * pw / d2
        out[r0:r0 + step] = torch.stack([(dx * inv).sum(dim=1),
                                         (dy * inv).sum(dim=1)], dim=1)
    return out


def grid_far_ref(pos, cell_xyw, cl2: float, md2: float) -> torch.Tensor:
    """pos [n, 2] vs cell aggregates [nc, 3] (x, y, mass) → [n, 2]."""
    return two_set_ref(pos, cell_xyw[:, :2], cell_xyw[:, 2], cl2, md2)


def grid_near_lanes_ref(pos, mass, vmask, bucket, table, consts):
    """B independent lanes (pos [B, n, 2], mass/vmask [B, n], bucket
    [B, nc+1, cap] of local ids, consts [B, 2]; the table shared) →
    [B, n, 2]; lane b is ``grid_near_ref`` of lane b alone."""
    return torch.stack([grid_near_ref(pos[b], mass[b], vmask[b], bucket[b],
                                      table, consts[b, 0], consts[b, 1])
                        for b in range(pos.shape[0])])


def grid_far_lanes_ref(pos, cell_xyw, consts):
    """B independent lanes (pos [B, n, 2], cell_xyw [B, nc, 3], consts
    [B, 2]) → [B, n, 2]; lane b is ``grid_far_ref`` of lane b alone."""
    return torch.stack([grid_far_ref(pos[b], cell_xyw[b], consts[b, 0],
                                     consts[b, 1])
                        for b in range(pos.shape[0])])
