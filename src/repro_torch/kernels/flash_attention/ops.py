"""Attention: the wrapper of the CUDA kernels (csrc/flash_attention.cu).

A CPU tensor runs the plain PyTorch version (ref.py); a CUDA tensor launches
a kernel or raises. Nothing else picks the path.

On the card the shapes alone pick one of two routes (``route``):

- ``split_kv`` (flash-decoding) where the packed rows ``Sq·(H/KV)`` fit one
  small tile (``SPLIT_ROWS``): the keys of each (batch, KV head) are split
  into chunks (``split_plan``), each block writes a partial softmax to
  float32 scratch, and the last block of each (batch, KV head) to finish
  merges them — a decode step;
- ``wgmma`` otherwise: the warp-specialised TMA + wgmma kernel — prefill and
  chunked prefill.

Both read the grouped KV head of each query head in place (no ``repeat`` of
k/v) and take the batch strides of k and v, so a caller may hand them
``cache[:, :kv_len]`` without a copy. The split-KV route also takes
``kv_len`` as an int32 tensor on the device (the JAX package's traced
``_sdpa(kv_len=)``): it then reads the whole cache's capacity, plans its
splits from it and masks the keys at or past ``kv_len`` on the device, so
one captured decode step serves every position. One wrapper call counts one
launch of ``flash_attention``, whichever route and however many device
kernels it runs.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ref import flash_attention_ref

HEAD_DIMS = (64, 128)          # the kernels' template instantiations
SPLIT_ROWS = 64                # Sq·(H/KV) ≤ this → the split-KV route
SPLIT_CHUNKS = (64, 128)       # keys per split chunk the kernel is built for
SPLIT_BLOCKS_PER_SM = 4        # split until this many blocks per SM, or the
                               # chunks reach the shorter length


def route(Sq: int, H: int, KV: int) -> str:
    """``"split_kv"`` when the ``Sq·(H/KV)`` packed rows fit one small tile,
    else ``"wgmma"``."""
    return "split_kv" if Sq * (H // KV) <= SPLIT_ROWS else "wgmma"


def split_plan(B: int, KV: int, Sk: int, sm_count: int) -> tuple[int, int]:
    """``(splits, chunk)`` of the split-KV route: the longer chunk when it
    still gives ``SPLIT_BLOCKS_PER_SM`` blocks per SM over the ``B·KV``
    (batch, KV head) pairs, else the shorter; ``splits = ⌈Sk / chunk⌉``
    (at least 1: a block with no keys writes an empty partial)."""
    want = SPLIT_BLOCKS_PER_SM * sm_count
    long_, short = max(SPLIT_CHUNKS), min(SPLIT_CHUNKS)
    chunk = long_ if B * KV * -(-Sk // long_) >= want else short
    return max(1, -(-Sk // chunk)), chunk


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_tickets: dict[tuple[int, int], torch.Tensor] = {}


def _tickets_for(dev: torch.device, stream: int, n: int) -> torch.Tensor:
    """int32 counters of the split-KV merge, one per (batch, KV head): the
    kernel leaves them zero, so they persist, one buffer per (device,
    stream) so that launches which may overlap never share one."""
    buf = _tickets.get((dev.index, stream))
    if buf is None or buf.numel() < n:
        buf = torch.zeros(max(n, 256), dtype=torch.int32, device=dev)
        _tickets[(dev.index, stream)] = buf
    return buf


def flash_attention(q, k, v, *, causal: bool = True,
                    kv_len: torch.Tensor | None = None) -> torch.Tensor:
    """q [B, Sq, H, hd]; k/v [B, Sk, KV, hd] → [B, Sq, H, hd] (ref.py has
    the function: GQA, float32 softmax, bottom-right causal mask). With
    ``kv_len`` (an int32 0-d tensor on q's device, ≤ Sk) the keys at or
    past it are masked and the causal mask is aligned at it, as if k/v were
    ``[:, :kv_len]``; only the split-KV route takes it."""
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, kv_len=kv_len)
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
    lib = _build.load()
    stream = _build.stream_of(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Sq,
            Sk, H, KV, hd, k.stride(0), v.stride(0), int(causal))
    split = route(Sq, H, KV) == "split_kv"
    if kv_len is not None:
        if not split:
            raise ValueError("flash_attention: a device kv_len is taken by "
                             "the split-KV route only (Sq·H/KV ≤ "
                             f"{SPLIT_ROWS}), not at Sq {Sq}")
        _build.require(kv_len, "kv_len", torch.int32, (), dev)
    if split:
        splits, chunk = split_plan(B, KV, Sk, _sm_count(dev.index))
        rows = B * KV * splits * Sq * (H // KV)
        part_o = torch.empty(rows * hd, dtype=torch.float32, device=dev)
        part_ml = torch.empty(rows * 2, dtype=torch.float32, device=dev)
        tickets = _tickets_for(dev, stream, B * KV)
        err = lib.flash_attention_split_launch(
            *args, splits, chunk,
            None if kv_len is None else kv_len.data_ptr(),
            part_o.data_ptr(), part_ml.data_ptr(), tickets.data_ptr(), stream)
    else:
        err = lib.flash_attention_wgmma_launch(*args, stream)
    _build.count("flash_attention", B, Sq, Sk)
    _build.check(err, "flash_attention")
    return out
