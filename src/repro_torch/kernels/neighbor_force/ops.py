"""Neighbor-list FR repulsion: the wrapper of the CUDA kernel
(csrc/neighbor_force.cu), which gathers neighbor positions itself.

A CPU tensor runs the plain PyTorch version (ref.py); a CUDA tensor launches
the kernel or raises. Lists with K % 4 == 0 whose ``nbr_idx`` is 16-byte and
``nbr_mask`` 4-byte aligned (every contiguous tensor that PyTorch allocates)
take the kernel's vector loads; other lists, such as a view that starts
mid-row, take its scalar path, with the same result.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.neighbor_force.ref import neighbor_repulsion_ref


def neighbor_split(K: int) -> tuple[int, int]:
    """(R, G) for rows of K slots: R rows a warp, S = 32 / R lanes a row, G
    groups of 4 consecutive slots a lane. A lane a group, S a power of two
    from 8 to 32; past 32 groups (K 128) a lane takes 2, which covers K 256
    in one pass (longer rows take more). At the layout path's K 128 and
    K 256, one row a warp in one pass timed fastest on an H100 of the
    splits with 1, 2 or 4 rows a warp."""
    groups = -(-K // 4)
    lanes = min(32, max(8, 1 << (groups - 1).bit_length()))
    return 32 // lanes, 1 if groups <= 32 else 2


def neighbor_repulsion(pos, mass, nbr_idx, nbr_mask, vmask, consts
                       ) -> torch.Tensor:
    """pos f32[n, 2]; mass f32[n]; nbr_idx int32[n, K] (sentinel n);
    nbr_mask bool[n, K]; vmask bool[n] → forces f32[n, 2]. ``consts``
    f32[2] = (C·L², md²) on pos's device (``_build.consts_tensor``).

    Any int32 index is taken, as the JAX package's gather from the (n+1)-row
    padded tables takes it (``ref.resolve_slots``): a negative index gets
    n+1 added, then the index is clamped to [0, n]. A masked-in slot that
    resolves to row n (the sentinel, an index ≥ n, or −1) adds 0; one below
    −(n+1) reads vertex 0."""
    if pos.device.type == "cpu":
        return neighbor_repulsion_ref(pos, mass, nbr_idx, nbr_mask, vmask,
                                      consts[0], consts[1])
    if pos.device.type != "cuda":
        raise ValueError(f"neighbor_repulsion: unsupported device {pos.device}")
    n, dev = pos.shape[0], pos.device
    K = int(nbr_idx.shape[1])
    _build.require(pos, "pos", torch.float32, (n, 2), dev)
    _build.require(mass, "mass", torch.float32, (n,), dev)
    _build.require(vmask, "vmask", torch.bool, (n,), dev)
    _build.require(nbr_idx, "nbr_idx", torch.int32, (n, K), dev)
    _build.require(nbr_mask, "nbr_mask", torch.bool, (n, K), dev)
    if pos.data_ptr() % 8:
        raise ValueError("neighbor_repulsion: pos must be 8-byte aligned "
                         "(float2 loads)")
    vec = int(K % 4 == 0 and nbr_idx.data_ptr() % 16 == 0
              and nbr_mask.data_ptr() % 4 == 0)
    rows, groups = neighbor_split(K)
    _build.require(consts, "consts", torch.float32, (2,), dev)
    packed = torch.empty((n, 4), dtype=torch.float32, device=dev)
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    err = _build.load().neighbor_repulsion_launch(
        pos.data_ptr(), mass.data_ptr(), vmask.data_ptr(), nbr_idx.data_ptr(),
        nbr_mask.data_ptr(), n, K, rows, groups, vec, consts.data_ptr(),
        packed.data_ptr(), out.data_ptr(), _build.stream_of(pos))
    _build.launches["neighbor_force"] += 1
    _build.check(err, "neighbor_repulsion")
    return out
