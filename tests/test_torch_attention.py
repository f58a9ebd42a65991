"""The port's plain flash attention against the JAX package on the CPU.

The port's ``flash_attention`` takes q [B,Sq,H,hd], k/v [B,Sk,KV,hd] (GQA) and
on a CPU tensor runs its plain version (``ref.py``), which is what these
tests hold to JAX on the same numpy-seeded inputs:

- ``flash_attention_pallas(..., interpret=True)`` for Sq == Sk, causal and
  full, on the flattened [B·H, S, hd] rows the JAX op builds (k/v repeated
  over each KV head's query heads), as ``tests/test_kernels.py`` sweeps it;
  and, with the queries padded in front, for Sk > Sq, at the LM models'
  head layouts: GQA groups 9 and 12 (starcoder2), 8 at hd 256 (gemma-2b's
  MQA), 3 at hd 64 and 1 (the MoE models);
- JAX's ``flash_attention_ref`` for Sk > Sq, causal (the case that sweep
  skips: both align the mask bottom-right);
- the model's ``repro.models.layers._sdpa`` with GQA, ``q_offset`` and
  ``kv_len`` on a longer cache, at ragged sizes, against the port on the
  cache sliced to ``kv_len``; and one case with fully masked rows.

The split-KV route's own decomposition (``flash_attention_split_ref``:
per-chunk max, sum and unnormalised p·v, merged by the log-sum-exp rule) is
held to the plain version and to JAX's reference over several chunk
lengths, with empty chunks past Sk and chunks that every row's mask hides;
``route`` and ``split_plan`` are tested for the shapes the card sees.

Tolerances, as the JAX sweep states them: 2e-5 (rtol and atol) in float32,
where both sides compute the same float32 softmax and differ only in the
order of the sums; 2e-2 in bf16, where the sides round at different points
(JAX's kernel casts the unnormalised p to bf16 and ``_sdpa`` rounds the
scores to bf16 before the float32 softmax, the port casts the normalised p)
and a bf16 output is 2^-8 relative to one ulp.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.flash_attention.kernel import flash_attention_pallas
from repro.kernels.flash_attention.ref import \
    flash_attention_ref as jax_flash_ref
from repro.models.layers import _sdpa as jax_sdpa
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (
    flash_attention_ref, flash_attention_split_ref)

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(B, Sq, Sk, H, KV, hd, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32),
            rng.normal(size=(B, Sk, KV, hd)).astype(np.float32))


def _flat(x, G):
    """[B, S, heads, hd] → [B·heads·G, S, hd], each head repeated G times
    (the JAX op's row order: query head h = kv·G + g)."""
    B, S, nh, hd = x.shape
    return np.repeat(x.transpose(0, 2, 1, 3), G, axis=1).reshape(B * nh * G,
                                                                  S, hd)


def _port(q, k, v, tdt, **kw):
    out = flash_attention(*(torch.tensor(a).to(tdt) for a in (q, k, v)),
                          **kw)
    return out.float().numpy()


def _jax_rows_to_port(o, B, S, H, hd):
    return np.asarray(o, np.float32).reshape(B, H, S, hd).transpose(0, 2, 1, 3)


@pytest.mark.parametrize("B,S,H,KV,hd", [(2, 128, 2, 1, 64),
                                         (1, 256, 4, 2, 64),
                                         (2, 128, 2, 2, 32)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_pallas_interpret(B, S, H, KV, hd, causal, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(B, S, S, H, KV, hd, seed=S + hd)
    # round to the working dtype first, so both sides see the same inputs
    q, k, v = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
    ref = flash_attention_pallas(
        jnp.asarray(_flat(q, 1), jdt), jnp.asarray(_flat(k, H // KV), jdt),
        jnp.asarray(_flat(v, H // KV), jdt), causal=causal, block_q=128,
        block_k=128, interpret=True)
    out = _port(q, k, v, tdt, causal=causal)
    np.testing.assert_allclose(out, _jax_rows_to_port(ref, B, S, H, hd),
                               rtol=tol, atol=tol)


def _pallas_rows(q, k, v, jdt, causal):
    """The Pallas kernel in interpret mode on the JAX op's flattened rows,
    one block over all of Sq and Sk (it takes blocks that divide the
    sequences). Its causal mask is aligned top-left, so for Sk > Sq the
    queries are padded in front to Sk rows and the last Sq rows are kept:
    the bottom-right mask of the port and of the model's cache."""
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    pad = Sk - Sq if causal and Sk > Sq else 0
    qp = np.concatenate([np.zeros((B, pad, H, hd), np.float32), q], axis=1)
    G = H // KV
    out = flash_attention_pallas(
        jnp.asarray(_flat(qp, 1), jdt), jnp.asarray(_flat(k, G), jdt),
        jnp.asarray(_flat(v, G), jdt), causal=causal, block_q=Sq + pad,
        block_k=Sk, interpret=True)
    return _jax_rows_to_port(np.asarray(out, np.float32)[:, pad:], B, Sq, H,
                             hd)


# starcoder2's GQA groups: 9 (7b, 36 heads over 4) and 12 (15b, 48 over 4),
# not powers of two, so the kernel's packed (position, head) rows put
# several positions in one 16-row MMA tile and start a 128-row tile
# mid-position. Sq 1 and 5 give the split-KV route's row counts (9 to 60
# packed rows), Sq 77 and 128 the wgmma route's, with Sk == Sq and Sk > Sq.
GQA_GROUPS = [(9, 1, 64, "bfloat16"), (18, 2, 128, "float32"),
              (12, 1, 128, "bfloat16"), (24, 2, 64, "float32")]


@pytest.mark.parametrize("H,KV,hd,dtype", GQA_GROUPS)
@pytest.mark.parametrize("Sq,Sk", [(1, 130), (5, 37), (77, 77), (77, 200),
                                   (128, 128), (128, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_interpret_at_groups_9_and_12(H, KV, hd, dtype,
                                                           Sq, Sk, causal):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(1, Sq, Sk, H, KV, hd, seed=Sq * Sk + H)
    q, k, v = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
    ref = _pallas_rows(q, k, v, jdt, causal)
    out = _port(q, k, v, tdt, causal=causal)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


# gemma-2b's MQA at hd 256 (8 heads over 1: group 8), granite-moe-3b-a800m's
# group 3 at hd 64 (24 over 8) and deepseek-moe-16b's MHA at hd 128 (16
# over 16): Sq 1, 5 and 8 give the split-KV route's row counts, Sq 77 and
# 128 the wgmma route's
NEW_SHAPES = [(8, 1, 256, "bfloat16"), (8, 1, 256, "float32"),
              (24, 8, 64, "bfloat16"), (16, 16, 128, "float32")]


@pytest.mark.parametrize("H,KV,hd,dtype", NEW_SHAPES)
@pytest.mark.parametrize("Sq,Sk", [(1, 130), (5, 37), (8, 100), (77, 77),
                                   (77, 200), (128, 256)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_matches_pallas_interpret_at_hd_256_and_groups_3_and_1(
        H, KV, hd, dtype, Sq, Sk, causal):
    jdt, tdt, tol = DTYPES[dtype]
    q, k, v = _inputs(1, Sq, Sk, H, KV, hd, seed=Sq * Sk + H + hd)
    q, k, v = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
    ref = _pallas_rows(q, k, v, jdt, causal)
    out = _port(q, k, v, tdt, causal=causal)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


@pytest.mark.parametrize("Sq,Sk", [(128, 256), (77, 200), (1, 130)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_jax_ref_longer_keys_causal(Sq, Sk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    B, H, KV, hd = 2, 4, 2, 32
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, seed=Sq * Sk)
    q, k, v = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
    ref = jax_flash_ref(jnp.asarray(_flat(q, 1), jdt),
                        jnp.asarray(_flat(k, H // KV), jdt),
                        jnp.asarray(_flat(v, H // KV), jdt), causal=True)
    out = _port(q, k, v, tdt, causal=True)
    np.testing.assert_allclose(out, _jax_rows_to_port(ref, B, Sq, H, hd),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("S,pos,cache_len", [(77, 0, 96), (77, 19, 128),
                                             (1, 90, 128), (5, 40, 45)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_plain_matches_model_sdpa_on_a_cache(S, pos, cache_len, dtype):
    """``_sdpa`` on the whole cache with q_offset = pos and kv_len = pos + S
    against the port on ``cache[:, :pos + S]`` (what the port's attention
    block hands the kernel)."""
    jdt, tdt, tol = DTYPES[dtype]
    B, H, KV, hd = 2, 4, 2, 16
    q, k, v = _inputs(B, S, cache_len, H, KV, hd, seed=S + pos)
    q, k, v = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
    kv_len = pos + S
    ref = jax_sdpa(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                   jnp.asarray(v, jdt), causal=True, q_offset=pos,
                   kv_len=kv_len)
    tq, tk, tv = (torch.tensor(a).to(tdt) for a in (q, k, v))
    out = flash_attention(tq, tk[:, :kv_len], tv[:, :kv_len], causal=True)
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), rtol=tol, atol=tol)


def test_fully_masked_rows_give_zero():
    """Sq > Sk, causal: rows 0 … Sq − Sk − 1 sit before every key. The port
    gives 0 there (not NaN), as ``_sdpa`` does with the same mask."""
    B, Sq, Sk, H, KV, hd = 1, 9, 4, 2, 1, 8
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, seed=5)
    out = _port(q, k, v, torch.float32, causal=True)
    assert np.isfinite(out).all()
    assert (out[:, :Sq - Sk] == 0).all()
    ref = jax_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   causal=True, q_offset=Sk - Sq)
    np.testing.assert_allclose(out, np.asarray(ref), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("Sq,Sk,chunk,splits", [
    (1, 130, 64, None),       # decode: a ragged last chunk
    (1, 130, 16, 12),         # three empty chunks past Sk
    (3, 100, 8, None),        # many chunks, several rows
    (40, 48, 8, None),        # early rows: the last chunks are fully masked
    (9, 4, 2, 3),             # Sq > Sk: rows that see no key at all → 0
    (5, 37, 128, None),       # one chunk longer than Sk
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_decomposition_matches_plain(Sq, Sk, chunk, splits, causal,
                                           dtype):
    _, tdt, tol = DTYPES[dtype]
    B, H, KV, hd = 2, 4, 2, 16
    q, k, v = (torch.tensor(a).to(tdt)
               for a in _inputs(B, Sq, Sk, H, KV, hd, seed=Sq + Sk + chunk))
    out = flash_attention_split_ref(q, k, v, causal=causal, chunk=chunk,
                                    splits=splits)
    ref = flash_attention_ref(q, k, v, causal=causal)
    np.testing.assert_allclose(out.float().numpy(), ref.float().numpy(),
                               rtol=tol, atol=tol)
    if causal and Sq > Sk:
        assert (out[:, :Sq - Sk] == 0).all()


@pytest.mark.parametrize("Sq,Sk,chunk", [(1, 130, 64), (4, 200, 32),
                                         (2, 77, 16)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_split_decomposition_matches_jax_ref(Sq, Sk, chunk, dtype):
    jdt, tdt, tol = DTYPES[dtype]
    B, H, KV, hd = 2, 4, 2, 32
    q, k, v = _inputs(B, Sq, Sk, H, KV, hd, seed=Sq * Sk + chunk)
    q, k, v = (np.asarray(jnp.asarray(a, jdt), np.float32) for a in (q, k, v))
    ref = jax_flash_ref(jnp.asarray(_flat(q, 1), jdt),
                        jnp.asarray(_flat(k, H // KV), jdt),
                        jnp.asarray(_flat(v, H // KV), jdt), causal=True)
    out = flash_attention_split_ref(*(torch.tensor(a).to(tdt)
                                      for a in (q, k, v)),
                                    causal=True, chunk=chunk)
    np.testing.assert_allclose(out.float().numpy(),
                               _jax_rows_to_port(ref, B, Sq, H, hd),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("G", [1, 2, 4, 8, 9, 12])
def test_route_threshold(G):
    """Sq·G ≤ SPLIT_ROWS packed rows take the split-KV route."""
    at = flash_ops.SPLIT_ROWS // G
    assert flash_ops.route(at, 2 * G, 2) == "split_kv"
    assert flash_ops.route(at + 1, 2 * G, 2) == "wgmma"
    assert flash_ops.route(1, 16, 8) == "split_kv"          # LM decode
    assert flash_ops.route(2048, 16, 8) == "wgmma"          # LM prefill
    for H, KV in ((36, 4), (48, 4),                        # starcoder2
                  (8, 1), (24, 8), (16, 16)):                # gemma, MoE
        assert flash_ops.route(1, H, KV) == "split_kv"
        assert flash_ops.route(2048, H, KV) == "wgmma"


SPLIT_SHAPES = [(4, 8, 2080, 132), (1, 8, 2080, 132), (4, 8, 2080, 78),
                (4, 4, 2088, 132), (1, 1, 1, 132), (1, 1, 0, 132),
                (8, 32, 32768, 132)]


@pytest.mark.parametrize("B,KV,Sk,sms", SPLIT_SHAPES)
def test_split_plan(B, KV, Sk, sms):
    _check_split_plan(B, KV, Sk, sms, 128)


# gemma-2b's decode (KV 1) and deepseek-moe-16b's (KV 16) beside the
# shapes above, at each head dim the kernel is built for
@pytest.mark.parametrize("B,KV,Sk,sms", SPLIT_SHAPES + [(4, 1, 2088, 132),
                                                        (4, 16, 2088, 132)])
@pytest.mark.parametrize("hd", flash_ops.HEAD_DIMS)
def test_split_plan_at_each_head_dim(B, KV, Sk, sms, hd):
    _check_split_plan(B, KV, Sk, sms, hd)


def _check_split_plan(B, KV, Sk, sms, hd):
    splits, chunk = flash_ops.split_plan(B, KV, Sk, sms, hd)
    assert chunk in flash_ops.SPLIT_CHUNKS[hd] and splits >= 1
    assert splits * chunk >= Sk > (splits - 1) * chunk or Sk == 0
    if chunk == 128:                           # the long chunk fills the card
        assert B * KV * splits >= flash_ops.SPLIT_BLOCKS_PER_SM * sms
    if (B, KV, Sk, sms) == (4, 8, 2080, 132):  # the LM path's decode
        assert B * KV * splits >= 2 * sms
    if hd == 256:                              # one chunk length, 64 keys
        assert chunk == 64
    if (B, KV, Sk, hd) == (4, 1, 2088, 256):   # gemma-2b's decode
        assert (splits, B * KV * splits) == (33, 132)
