"""All-pairs FR repulsion: the wrapper of the CUDA kernel (csrc/nbody.cu).

A CPU tensor runs the plain PyTorch version (ref.py); a CUDA tensor launches
the kernel or raises. Nothing else picks the route. The wrapper takes one
vertex set or B of them (lanes, the batched driver's groups): a single set
is the one-lane case of the same launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.nbody.ref import nbody_repulsion_lanes_ref


def nbody_repulsion(pos, mass, vmask, consts) -> torch.Tensor:
    """pos f32[n, 2]; mass f32[n]; vmask bool[n] → forces f32[n, 2].
    ``consts`` f32[2] = (C·L², md²) on pos's device
    (``_build.consts_tensor``), which the kernel reads through a pointer.
    Lanes: pos f32[B, n, 2], mass f32[B, n], vmask bool[B, n] and consts
    f32[B, 2] (lane b's constants) → f32[B, n, 2], one launch for all B."""
    if pos.dim() == 2:
        return nbody_repulsion(pos[None], mass[None], vmask[None],
                               consts[None])[0]
    if pos.device.type == "cpu":
        return nbody_repulsion_lanes_ref(pos, mass, vmask, consts)
    if pos.device.type != "cuda":
        raise ValueError(f"nbody_repulsion: unsupported device {pos.device}")
    B, n, dev = pos.shape[0], pos.shape[1], pos.device
    _build.require(pos, "pos", torch.float32, (B, n, 2), dev)
    _build.require(mass, "mass", torch.float32, (B, n), dev)
    _build.require(vmask, "vmask", torch.bool, (B, n), dev)
    if pos.data_ptr() % 8:
        raise ValueError("nbody_repulsion: pos must be 8-byte aligned "
                         "(float2 loads)")
    _build.require(consts, "consts", torch.float32, (B, 2), dev)
    out = torch.empty((B, n, 2), dtype=torch.float32, device=dev)
    err = _build.load().nbody_repulsion_launch(
        pos.data_ptr(), mass.data_ptr(), vmask.data_ptr(), n, B,
        consts.data_ptr(), out.data_ptr(), _build.stream_of(pos))
    _build.count("nbody", B, n)
    _build.check(err, "nbody_repulsion")
    return out
