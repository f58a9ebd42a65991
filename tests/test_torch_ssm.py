"""The port's SSD layer (``repro_torch.models.ssm``) against the JAX
package's ``repro.models.ssm`` on the CPU.

The JAX package's ``init_ssm`` weights (with ``dt_bias``, ``D`` and
``conv_b`` drawn away from 0, 1 and 0, so that each reaches the op that
reads it) are carried across with ``repro_torch.convert.ssm_params``, and
both sides run on the same numpy-seeded input, rounded to the working dtype
first. Three shapes: the mamba2-1.3b smoke config (N = P = 16, chunk 32)
and two with N ≠ P (N 32 over P 16, N 8 over P 16, chunk 16), so that both
orders of the three-operand einsums' pairwise products run
(``_pair_first``, held to ``jnp.einsum_path``).

- ``_causal_conv`` with and without a state; ``apply_ssm`` on a ragged
  prompt (S not a multiple of the chunk) with its final (conv, h) state,
  from a zero state and from a given one; ``apply_ssm_decode`` k steps
  from that state;
- the port against itself: a prefill split in two halves through
  ``initial_state`` equals the whole; k decode steps after a prefill equal
  one prefill of S + k; the dt = 0 padding of a ragged prompt leaves h
  bit for bit as it is whatever the padded rows hold, and the conv state
  is the last W−1 unpadded rows before the convolution.

Tolerances, as the LM tests': float32 rtol = atol = 1e-4 (the same float32
function, sums in another order; XLA's cumsum and exp are not torch's);
bf16 rtol 0.02, atol 0.1 (the activations, the products and h round to
bf16, and XLA may keep a fused elementwise chain in float32 where torch
rounds each op).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models.ssm as jax_ssm
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import ssm as port_ssm

TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.02, atol=0.1)}
DT = {"float32": (jnp.float32, torch.float32),
      "bfloat16": (jnp.bfloat16, torch.bfloat16)}
SHAPES = {"mamba2-smoke": {},
          "N32-P16": dict(d_state=32, head_dim=16, chunk=16),
          "N8-P16": dict(d_state=8, head_dim=16, chunk=16)}


def _cfgs(shape):
    """(the JAX config, the port's) of the mamba2-1.3b smoke config with
    the SSD fields of ``shape`` changed."""
    jcfg = jax_get_smoke_config("mamba2-1.3b")
    pcfg = get_smoke_config("mamba2-1.3b")
    change = SHAPES[shape]
    return (dataclasses.replace(jcfg, ssm=dataclasses.replace(jcfg.ssm,
                                                              **change)),
            dataclasses.replace(pcfg, ssm=dataclasses.replace(pcfg.ssm,
                                                              **change)))


@pytest.fixture(params=sorted(SHAPES))
def layer(request):
    """(JAX cfg, JAX params, port cfg, numpy params) of one SSD layer."""
    jcfg, pcfg = _cfgs(request.param)
    p = jax.tree.map(np.asarray, jax_ssm.init_ssm(jax.random.PRNGKey(3),
                                                  jcfg))
    rng = np.random.default_rng(5)
    H = p["D"].shape[0]
    p["dt_bias"] = (0.5 * rng.standard_normal(H)).astype(np.float32)
    p["D"] = (1 + 0.3 * rng.standard_normal(H)).astype(np.float32)
    p["conv_b"] = (0.1 * rng.standard_normal(p["conv_b"].shape)
                   ).astype(np.float32)
    return jcfg, jax.tree.map(jnp.asarray, p), pcfg, p


def _port(pcfg, p, dtype):
    return convert.ssm_params(p, pcfg, device="cpu", dtype=DT[dtype][1])


def _draw(rng, dtype, *shape):
    """The same values on both sides: drawn in float32, rounded to the
    dtype once."""
    x = rng.standard_normal(shape).astype(np.float32)
    t = torch.from_numpy(x).to(DT[dtype][1])
    return jnp.asarray(t.float().numpy()).astype(DT[dtype][0]), t


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor)
                      else np.asarray(x, np.float32), np.float32)


def _close(got, want, dtype):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype])


def _einsum_path(spec, *shapes):
    ops = [np.zeros(s, np.float32) for s in shapes]
    return tuple(jnp.einsum_path(spec, *ops, optimize="auto")[0][0])


@pytest.mark.parametrize("name,N,P,H", [
    ("mamba2-smoke", 16, 16, 8), ("N32-P16", 32, 16, 8),
    ("N8-P16", 8, 16, 8), ("mamba2-1.3b", 128, 64, 64),
    ("jamba-v0.1-52b", 16, 64, 128)])
def test_pair_order_matches_jnp_einsum_path(name, N, P, H):
    """``_pair_first`` picks the pair that ``jnp.einsum`` contracts first
    in the SSD's three three-operand einsums (chunk summaries, inter-chunk
    output, decode update), so that the bf16 roundings fall where JAX's
    do; at the smoke shapes of the tests and the published configs."""
    if name in ("mamba2-1.3b", "jamba-v0.1-52b"):
        s = jax_get_config(name).ssm
        assert (s.d_state, s.head_dim) == (N, P)
    B, nC, Q = 4, 8, 256
    first = (0, 1)
    assert ((_einsum_path("bcjh,bcjn,bcjhp->bchnp", (B, nC, Q, H),
                          (B, nC, Q, N), (B, nC, Q, H, P)) == first)
            == port_ssm._pair_first(N, P))
    assert ((_einsum_path("bcin,bchnp,bcih->bcihp", (B, nC, Q, N),
                          (B, nC, H, N, P), (B, nC, Q, H)) == first)
            == port_ssm._pair_first(P, N))
    assert ((_einsum_path("bh,bn,bhp->bhnp", (B, H), (B, N), (B, H, P))
             == first) == port_ssm._pair_first(N, P))


@pytest.mark.parametrize("dtype", sorted(TOL))
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_jax(layer, dtype, with_state):
    jcfg, jp, pcfg, p = layer
    port = _port(pcfg, p, dtype)
    rng = np.random.default_rng(1)
    W, ch = p["conv_w"].shape
    xj, xt = _draw(rng, dtype, 2, 11, ch)
    sj, st = _draw(rng, dtype, 2, W - 1, ch) if with_state else (None, None)
    oj, nj = jax_ssm._causal_conv(xj, jp["conv_w"], jp["conv_b"], sj)
    ot, nt = port_ssm._causal_conv(xt, port.conv_w, port.conv_b, st)
    _close(ot, oj, dtype)
    assert nt.dtype == xt.dtype
    np.testing.assert_array_equal(_np(nt), _np(nj))


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_apply_ssm_ragged_prompt_and_state_match_jax(layer, dtype):
    """S = 2.5 chunks: the output and the final (conv, h) from a zero
    state, then a second ragged prompt from that state."""
    jcfg, jp, pcfg, p = layer
    port = _port(pcfg, p, dtype)
    rng = np.random.default_rng(2)
    S = 5 * jcfg.ssm.chunk // 2
    xj, xt = _draw(rng, dtype, 2, S, jcfg.d_model)
    yj, sj = jax_ssm.apply_ssm(jp, xj, jcfg, return_state=True)
    yt, st = port_ssm.apply_ssm(port, xt, pcfg, return_state=True)
    _close(yt, yj, dtype)
    for a, b in zip(st, (sj["conv"], sj["h"])):
        assert a.dtype == xt.dtype
        _close(a, b, dtype)
    xj, xt = _draw(rng, dtype, 2, 7, jcfg.d_model)
    yj, sj = jax_ssm.apply_ssm(jp, xj, jcfg, return_state=True,
                               initial_state=sj)
    yt, st = port_ssm.apply_ssm(port, xt, pcfg, return_state=True,
                                initial_state=st)
    _close(yt, yj, dtype)
    for a, b in zip(st, (sj["conv"], sj["h"])):
        _close(a, b, dtype)
    # without return_state: the output alone, the same
    _close(port_ssm.apply_ssm(port, xt, pcfg, initial_state=None),
           jax_ssm.apply_ssm(jp, xj, jcfg), dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_decode_steps_match_jax_and_a_longer_prefill(layer, dtype):
    """k = 4 ``apply_ssm_decode`` steps after a prefill of S: each step's
    output and the state written in place against JAX's steps; the port's
    steps' outputs and final state against its own prefill of S + k."""
    jcfg, jp, pcfg, p = layer
    port = _port(pcfg, p, dtype)
    rng = np.random.default_rng(3)
    S, k = jcfg.ssm.chunk + 5, 4
    xj, xt = _draw(rng, dtype, 2, S + k, jcfg.d_model)
    _, sj = jax_ssm.apply_ssm(jp, xj[:, :S], jcfg, return_state=True)
    _, st = port_ssm.apply_ssm(port, xt[:, :S], pcfg, return_state=True)
    st = tuple(t.clone() for t in st)
    ys = []
    for i in range(k):
        yj, sj = jax_ssm.apply_ssm_decode(jp, xj[:, S + i:S + i + 1], jcfg,
                                          sj)
        yt = port_ssm.apply_ssm_decode(port, xt[:, S + i:S + i + 1], pcfg,
                                       st)
        _close(yt, yj, dtype)
        for a, b in zip(st, (sj["conv"], sj["h"])):
            _close(a, b, dtype)
        ys.append(yt)
    y_all, s_all = port_ssm.apply_ssm(port, xt, pcfg, return_state=True)
    _close(torch.cat(ys, 1), y_all[:, S:], dtype)
    for a, b in zip(st, s_all):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_prefill_in_two_halves_equals_the_whole(layer, dtype):
    """Two chunk-aligned halves through ``initial_state`` against one
    prefill: output and state, the port against itself and against JAX's
    two halves."""
    jcfg, jp, pcfg, p = layer
    port = _port(pcfg, p, dtype)
    rng = np.random.default_rng(4)
    S = 4 * jcfg.ssm.chunk
    xj, xt = _draw(rng, dtype, 2, S, jcfg.d_model)
    y_all, s_all = port_ssm.apply_ssm(port, xt, pcfg, return_state=True)
    h = S // 2
    y1, s1 = port_ssm.apply_ssm(port, xt[:, :h], pcfg, return_state=True)
    y2, s2 = port_ssm.apply_ssm(port, xt[:, h:], pcfg, return_state=True,
                                initial_state=s1)
    _close(torch.cat([y1, y2], 1), y_all, dtype)
    for a, b in zip(s2, s_all):
        _close(a, b, dtype)
    _, sj = jax_ssm.apply_ssm(jp, xj[:, :h], jcfg, return_state=True)
    yj, sj = jax_ssm.apply_ssm(jp, xj[:, h:], jcfg, return_state=True,
                               initial_state=sj)
    _close(y2, yj, dtype)
    for a, b in zip(s2, (sj["conv"], sj["h"])):
        _close(a, b, dtype)


@pytest.mark.parametrize("dtype", sorted(TOL))
def test_ragged_padding_is_a_no_op_on_the_state(layer, dtype, monkeypatch):
    """A ragged prompt's h is bit for bit that of the same prompt followed
    by the rest of its last chunk at dt = 0, whatever those rows hold (the
    padded run's rows are zeros, the other's drawn values: its projections
    are the ragged prompt's, then the drawn rows, since a matmul over more
    rows may round a row otherwise); its conv state is its own last W−1
    rows before the convolution."""
    jcfg, jp, pcfg, p = layer
    port = _port(pcfg, p, dtype)
    rng = np.random.default_rng(6)
    Q = pcfg.ssm.chunk
    S = Q + Q // 2 + 3
    tail = (-S) % Q
    _, xt = _draw(rng, dtype, 2, S + tail, pcfg.d_model)
    _, (conv, h) = port_ssm.apply_ssm(port, xt[:, :S], pcfg,
                                      return_state=True)
    proj = port_ssm._proj_in

    def drawn_tail_at_dt_zero(p_, x):
        out = proj(p_, x[:, :S])
        rows = [_draw(rng, dtype, 2, tail, t.shape[-1])[1] for t in out[:4]]
        return tuple(torch.cat([t, r.to(t.dtype)], 1)
                     for t, r in zip(out, rows + [out[4].new_zeros(
                         (2, tail, out[4].shape[-1]))]))
    monkeypatch.setattr(port_ssm, "_proj_in", drawn_tail_at_dt_zero)
    _, (_, h_tail) = port_ssm.apply_ssm(port, xt, pcfg, return_state=True)
    assert torch.equal(h, h_tail)
    monkeypatch.setattr(port_ssm, "_proj_in", proj)
    z, xin, Bv, Cv, _ = proj(port, xt[:, :S])
    W = p["conv_w"].shape[0]
    assert torch.equal(conv, torch.cat([xin, Bv, Cv], -1)[:, S - (W - 1):])


def test_init_state_shapes_and_dtype():
    cfg = get_smoke_config("jamba-v0.1-52b")
    conv, h = port_ssm.init_ssm_state(cfg, 3, torch.bfloat16, "cpu")
    d_inner, H, conv_ch = port_ssm.dims(cfg)
    assert conv.shape == (3, cfg.ssm.conv_width - 1, conv_ch)
    assert h.shape == (3, H, cfg.ssm.d_state, cfg.ssm.head_dim)
    assert conv.dtype == h.dtype == torch.bfloat16
    assert not conv.any() and not h.any()
    jax_state = jax_ssm.init_ssm_state(jax_get_smoke_config(
        "jamba-v0.1-52b"), 3)
    assert (tuple(jax_state["conv"].shape), tuple(jax_state["h"].shape)) \
        == (tuple(conv.shape), tuple(h.shape))
