"""Attention: the wrapper of the CUDA kernel (csrc/flash_attention.cu).

A CPU tensor runs the plain PyTorch version (ref.py); a CUDA tensor launches
the kernel or raises. Nothing else picks the route.

The kernel reads the grouped KV head of each query head in place (no
``repeat`` of k/v) and takes the batch strides of k and v, so a decode step
hands it ``cache[:, :kv_len]`` without a copy.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (64, 128)          # the kernel's template instantiations


def flash_attention(q, k, v, *, causal: bool = True) -> torch.Tensor:
    """q [B, Sq, H, hd]; k/v [B, Sk, KV, hd] → [B, Sq, H, hd] (ref.py has
    the function: GQA, float32 softmax, bottom-right causal mask)."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention: head dim {hd}, the kernel "
                         f"takes {HEAD_DIMS}")
    if KV == 0 or H % KV:
        raise ValueError(f"flash_attention: {H} query heads over {KV} KV heads")
    dev = q.device
    _build.require(q, "q", torch.bfloat16, (B, Sq, H, hd), dev)
    for t, name in ((k, "k"), (v, "v")):
        # each batch's rows [Sk, KV, hd] dense; the batch stride is free, so
        # k/v may be a slice cache[:, :kv_len] of a longer cache
        if t.shape[0] != B:
            raise ValueError(f"{name}: batch {t.shape[0]}, expected {B}")
        _build.require(t[0], name, torch.bfloat16, (Sk, KV, hd), dev)
        if t.stride(0) % 8:
            raise ValueError(f"{name}: batch stride {t.stride(0)} is not a "
                             "multiple of 8 elements")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: q, k and v must be 16-byte aligned")
    out = torch.empty((B, Sq, H, hd), dtype=torch.bfloat16, device=dev)
    err = _build.load().flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq, Sk,
        H, KV, hd, k.stride(0), v.stride(0), int(causal),
        _build.stream_of(q))
    _build.launches["flash_attention"] += 1
    _build.check(err, "flash_attention")
    return out
