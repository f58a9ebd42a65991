"""Distributed-optimization tricks: the JAX package's
``parallel/collectives.py``.

* ``compress_grads`` / ``decompress_grads`` quantize each gradient to int8
  with one float32 scale a tensor; the quantization residual is carried in
  an error state and added back at the next step (EF-SGD), so the error
  stays O(1) over the steps instead of growing with them. The training
  step compresses the gradients after their sum over the batch axes, as
  the JAX package's step compresses the gradients GSPMD has reduced.
  Gradients and error states are dicts from a parameter's name to a
  tensor.

* ``ring_collective_matmul`` — all-gather-matmul overlap: instead of
  all-gather(x) → x @ W, the x blocks rotate around the ring of an axis
  (``batch_isend_irecv``) while each rank multiplies the block it holds.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import comm


def quantize_int8(x: torch.Tensor, amax=None):
    """Per-tensor symmetric int8 quantization → (q int8, scale float32 0-d):
    round half to even, as ``jnp.round``. ``amax`` maps the local max |x|
    to the tensor's (a block's to the whole leaf's, under a mesh)."""
    xf = x.float()
    m = xf.abs().max()
    scale = (m if amax is None else amax(m)).clamp_min(1e-12) / 127.0
    q = torch.round(xf / scale).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def compress_grads(grads: dict, error_state: dict, amax=None):
    """Quantize each gradient plus its carried error → ({name: (q, scale)},
    the new error state: what the quantization lost). Under a mesh the
    gradients are blocks and ``amax(name, local max)`` gives the leaf's
    max over its blocks, so the scale is the whole leaf's."""
    qs, errs = {}, {}
    for name, g in grads.items():
        corrected = g.float() + error_state[name]
        q, s = quantize_int8(corrected, None if amax is None
                             else (lambda m, n=name: amax(n, m)))
        qs[name] = (q, s)
        errs[name] = corrected - dequantize_int8(q, s)
    return qs, errs


def decompress_grads(qgrads: dict) -> dict:
    return {name: dequantize_int8(q, s) for name, (q, s) in qgrads.items()}


def init_error_state(grads_like: dict) -> dict:
    return {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for name, g in grads_like.items()}


def ring_collective_matmul(mesh, axis: str = "model"):
    """→ f(x_blk, w_blk) computing ``all_gather(x, axis) @ w`` with x [S, K]
    cut by rows over ``axis`` (x_blk [S/size, K], this rank's) and w [K, N]
    by columns (w_blk [K, N/size]) → [S, N/size], every row of this rank's
    columns. At step s rank d holds x block j = (d − s) mod size and fills
    output rows j; then the blocks move one rank up the ring. A one-rank
    axis multiplies its block and sends nothing."""
    group = mesh.group(axis)
    size = mesh.shape[axis]
    perm = [(i, (i + 1) % size) for i in range(size)]

    def f(x_blk, w_blk):
        idx = mesh.axis_index(axis)
        rows = [None] * size
        xs = x_blk
        for s in range(size):
            rows[(idx - s) % size] = xs @ w_blk
            if s + 1 < size:
                xs = comm.ppermute(xs, group, perm)
        return rows[0] if size == 1 else torch.cat(rows)

    return f
