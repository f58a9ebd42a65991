"""Gradient compression with error feedback: the one-device part of the
JAX package's ``parallel/collectives.py``.

``compress_grads`` / ``decompress_grads`` quantize each gradient to int8
with one float32 scale a tensor; the quantization residual is carried in an
error state and added back at the next step (EF-SGD), so the error stays
O(1) over the steps instead of growing with them. On one device the
training step compresses and decompresses in place of the data-parallel
all-reduce of the int8 payload. The sharded half (``ring_collective_matmul``
and the all-reduce itself) belongs to the port's ``parallel/`` sharding,
which is not ported yet (ROADMAP.md item 13.7's third slice).

Gradients and error states are dicts from a parameter's name to a tensor.
"""
from __future__ import annotations

import torch


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization → (q int8, scale float32 0-d):
    round half to even, as ``jnp.round``."""
    xf = x.float()
    scale = xf.abs().max().clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_grads(grads: dict, error_state: dict):
    """Quantize each gradient plus its carried error → ({name: (q, scale)},
    the new error state: what the quantization lost)."""
    qs, errs = {}, {}
    for name, g in grads.items():
        corrected = g.float() + error_state[name]
        q, s = quantize_int8(corrected)
        qs[name] = (q, s)
        errs[name] = corrected - dequantize_int8(q, s)
    return qs, errs


def decompress_grads(qgrads: dict) -> dict:
    return {name: dequantize_int8(q, s) for name, (q, s) in qgrads.items()}


def init_error_state(grads_like: dict) -> dict:
    return {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for name, g in grads_like.items()}
