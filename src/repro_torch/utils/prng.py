"""Threefry2x32 counter-based randomness, bit-identical to ``jax.random``.

The JAX package draws every random number on the layout path through
per-vertex streams (``fold_in`` the vertex id, then ``uniform``), plus one
``split`` per solar-merger round. The port reproduces those bits exactly, so
the hierarchy (suns, levels) is the same as the JAX package's at equal seeds.
The recipe is that of JAX's default ``threefry2x32`` implementation with
``jax_threefry_partitionable=True``:

* ``PRNGKey(s) = (0, s)`` for a 32-bit seed;
* ``fold_in(k, d) = threefry(k, (0, d))``;
* ``split(k)[i] = threefry(k, (0, i))``;
* the 32 random bits at flat index ``i`` are ``x0 ^ x1`` of
  ``threefry(k, (0, i))``;
* ``uniform = bitcast_f32((bits >> 9) | 0x3F800000) - 1``, then
  ``u * (max - min) + min`` as one fused multiply-add (XLA fuses it), then
  ``max(min, .)``;
* ``bernoulli(k, p, (n,))`` is ``uniform(k, (n,)) < p`` over the flat
  indices ``0 .. n-1`` (Spinner's coin flips, ``core/partition.py``).

A key is a pair of 32-bit words. Scalar keys are pairs of Python ints (the
host derives them without touching the device); per-vertex keys are pairs of
int64 tensors holding 32-bit values, so the cipher runs vectorised on
whatever device the ids live on. One function serves both: Python ints and
int64 tensors share ``+ ^ << >> &``.
"""
from __future__ import annotations

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(key, count):
    """Threefry-2x32 with 20 rounds: ``key = (k0, k1)``, ``count = (x0, x1)``
    → ``(y0, y1)``; each word a Python int or an int64 tensor of 32-bit
    values (broadcasting)."""
    k0, k1 = key
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (count[0] + ks[0]) & _MASK
    x1 = (count[1] + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + i + 1) & _MASK
    return x0, x1


def prng_key(seed: int) -> tuple[int, int]:
    """``jax.random.PRNGKey(seed)`` for a seed below 2**32."""
    seed = int(seed)
    return (seed >> 32) & _MASK, seed & _MASK


def fold_in(key, data: int) -> tuple[int, int]:
    """``jax.random.fold_in(key, data)`` for a host scalar."""
    return threefry2x32(key, (0, int(data) & _MASK))


def split(key, num: int = 2) -> list[tuple[int, int]]:
    """``jax.random.split(key, num)`` as a list of host keys."""
    return [threefry2x32(key, (0, i)) for i in range(num)]


def _bits_to_unit(bits: torch.Tensor) -> torch.Tensor:
    """32 random bits (int64) → float32 uniforms in [0, 1)."""
    mant = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return mant.view(torch.float32) - 1.0


def _per_vertex_uniform(key, ids: torch.Tensor, count: int,
                        minval: float, maxval: float) -> torch.Tensor:
    ids = ids.to(torch.int64) & _MASK
    vk = threefry2x32(key, (torch.zeros_like(ids), ids))
    cols = []
    for i in range(count):
        y0, y1 = threefry2x32(vk, (0, i))
        cols.append(_bits_to_unit(y0 ^ y1))
    u = torch.stack(cols, dim=1)
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    # XLA fuses ``u * span + lo`` into one fused multiply-add: the float32
    # product is exact in float64, so the float64 sum rounded to float32
    # gives the fused result
    out = (u.double() * float(span) + float(lo)).float()
    return torch.clamp_min(out, float(lo))


def uniform_per_vertex(key, ids: torch.Tensor, minval: float = 0.0,
                       maxval: float = 1.0) -> torch.Tensor:
    """float32[len(ids)]; element i depends only on (key, ids[i]) — the
    JAX package's ``utils.prng.uniform_per_vertex``."""
    return _per_vertex_uniform(key, ids, 1, minval, maxval)[:, 0]


def uniform2_per_vertex(key, ids: torch.Tensor, minval: float = 0.0,
                        maxval: float = 1.0) -> torch.Tensor:
    """float32[len(ids), 2] per-vertex uniforms (positions)."""
    return _per_vertex_uniform(key, ids, 2, minval, maxval)


def bernoulli(key, p: float, n: int, device=None) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, (n,))``: bool[n] on ``device``, element
    i true where the uniform at flat index i lies below ``p``."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    y0, y1 = threefry2x32(key, (torch.zeros_like(i), i))
    return _bits_to_unit(y0 ^ y1) < float(np.float32(p))
