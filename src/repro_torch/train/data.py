"""Deterministic synthetic data (restart-safe, host-shardable): the JAX
package's ``train/data.py``, its numpy copied.

Batches are a pure function of (seed, step) — no iterator state — so a
restart resumes the exact stream from the step alone, and each host of a
multi-host run makes only its own shard. Token streams follow a skewed
unigram distribution with short-range copies (the second half of each
64-token block repeats the first), so the LM loss is learnable. Tokens and
labels equal the JAX package's bit for bit; they come back as int32 CPU
tensors, and the stub frontends' frames and patches as bf16 CPU tensors
rounded as the JAX package rounds them.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models.model import VLM_PATCHES


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2


def _unigram(rng, vocab: int, a: float, size):
    # zipf-ish via inverse CDF over ranks, clipped to vocab
    u = rng.random(size)
    raw = np.minimum(u ** (-1.0 / (a - 1.0)), float(vocab))  # clip pre-cast
    ranks = raw.astype(np.int64) - 1
    perm_seed = 12345
    perm = np.random.default_rng(perm_seed).permutation(vocab)
    return perm[np.clip(ranks, 0, vocab - 1)]


def batch_at(cfg: DataConfig, step: int, *, host_id: int = 0,
             n_hosts: int = 1) -> dict:
    """This host's shard of batch ``step``: tokens and labels, int32
    [global_batch / n_hosts, seq_len]."""
    assert cfg.global_batch % n_hosts == 0
    per_host = cfg.global_batch // n_hosts
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, step, host_id]))
    toks = _unigram(rng, cfg.vocab, cfg.zipf_a,
                    (per_host, cfg.seq_len + 1)).astype(np.int32)
    # inject copy structure: second half of each 64-block repeats the first
    blk = 64
    nblk = (cfg.seq_len + 1) // blk
    view = toks[:, : nblk * blk].reshape(per_host, nblk, blk)
    view[:, :, blk // 2:] = view[:, :, : blk // 2]
    return {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}


def _bf16(x: np.ndarray) -> torch.Tensor:
    """float64 → bf16 as the JAX package's ``jnp.asarray(x, bfloat16)``
    rounds it with 64-bit mode off: to float32 first, then to bf16."""
    return torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)


def extra_inputs(cfg_arch, batch_size: int, seq_len: int, seed: int = 0):
    """Frontend-stub inputs (audio frames / VLM patches) for real runs."""
    rng = np.random.default_rng(seed)
    out = {}
    if cfg_arch.enc_layers:
        out["frames"] = _bf16(
            rng.normal(size=(batch_size, seq_len, cfg_arch.d_model)) * 0.02)
    if cfg_arch.modality == "vlm":
        n = min(VLM_PATCHES, seq_len // 2)
        out["patches"] = _bf16(
            rng.normal(size=(batch_size, n, cfg_arch.d_model)) * 0.02)
    return out
