"""All-pairs FR repulsion: the wrapper of the CUDA kernel (csrc/nbody.cu).

A CPU tensor runs the plain PyTorch version (ref.py); a CUDA tensor launches
the kernel or raises. Nothing else picks the route.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nbody.ref import nbody_repulsion_ref


def nbody_repulsion(pos, mass, vmask, C, L, min_dist) -> torch.Tensor:
    """pos f32[n, 2]; mass f32[n]; vmask bool[n] → forces f32[n, 2]."""
    cl2, md2 = _build.force_consts(C, L, min_dist)
    if pos.device.type == "cpu":
        return nbody_repulsion_ref(pos, mass, vmask, cl2, md2)
    if pos.device.type != "cuda":
        raise ValueError(f"nbody_repulsion: unsupported device {pos.device}")
    n, dev = pos.shape[0], pos.device
    _build.require(pos, "pos", torch.float32, (n, 2), dev)
    _build.require(mass, "mass", torch.float32, (n,), dev)
    _build.require(vmask, "vmask", torch.bool, (n,), dev)
    out = torch.empty((n, 2), dtype=torch.float32, device=dev)
    err = _build.load().nbody_repulsion_launch(
        pos.data_ptr(), mass.data_ptr(), vmask.data_ptr(), n, cl2, md2,
        out.data_ptr(), _build.stream_of(pos))
    _build.launches["nbody"] += 1
    _build.check(err, "nbody_repulsion")
    return out
