"""Neighbor-list FR repulsion: the wrapper of the CUDA kernel
(csrc/neighbor_force.cu), which gathers neighbor positions itself.

A CPU tensor runs the plain PyTorch version (ref.py); a CUDA tensor launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.neighbor_force.ref import neighbor_repulsion_ref


def neighbor_repulsion(pos, mass, nbr_idx, nbr_mask, vmask, C, L, min_dist
                       ) -> torch.Tensor:
    """pos f32[n, 2]; mass f32[n]; nbr_idx int32[n, K] (sentinel n);
    nbr_mask bool[n, K]; vmask bool[n] → forces f32[n, 2]."""
    cl2, md2 = _build.force_consts(C, L, min_dist)
    if pos.device.type == "cpu":
        return neighbor_repulsion_ref(pos, mass, nbr_idx, nbr_mask, vmask,
                                      cl2, md2)
    if pos.device.type != "cuda":
        raise ValueError(f"neighbor_repulsion: unsupported device {pos.device}")
    n, dev = pos.shape[0], pos.device
    K = int(nbr_idx.shape[1])
    _build.require(pos, "pos", torch.float32, (n, 2), dev)
    _build.require(mass, "mass", torch.float32, (n,), dev)
    _build.require(vmask, "vmask", torch.bool, (n,), dev)
    _build.require(nbr_idx, "nbr_idx", torch.int32, (n, K), dev)
    _build.require(nbr_mask, "nbr_mask", torch.bool, (n, K), dev)
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    err = _build.load().neighbor_repulsion_launch(
        pos.data_ptr(), mass.data_ptr(), vmask.data_ptr(), nbr_idx.data_ptr(),
        nbr_mask.data_ptr(), n, K, cl2, md2, out.data_ptr(),
        _build.stream_of(pos))
    _build.launches["neighbor_force"] += 1
    _build.check(err, "neighbor_repulsion")
    return out
