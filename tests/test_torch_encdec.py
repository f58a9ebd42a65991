"""The encoder-decoder and VLM pieces of the port's LM against the JAX package.

On the CPU, the same numpy-seeded inputs go through the JAX package's
``models/layers.py`` and ``models/model.py`` and the port's
``repro_torch.models``: the cross-attention's keys and values
(``cross_kv``), ``apply_attention``'s cross branch (q with no RoPE against
every frame, no mask) and its non-causal self-attention, the encoder stack
(``_encode``: RoPE at 0 … S_enc − 1, non-causal, ``enc_norm``), the
encoder's weights through ``convert.lm_params`` layer by layer, the tie of
encoder layers e and e + 4 that the JAX package's ``init_params`` makes,
the VLM's patch prefix in ``forward`` and chunked ``prefill``, and the
captured decode's static encoder output (``DecodeGraph``, eager on the
CPU). The model-level parity of the two smoke configs (forward, prefill,
chunked prefill, greedy decode) is in ``test_torch_lm.py``.

Tolerances are the LM tests': float32 (the JAX side switched to float32
through its two activation dtype globals) rtol = atol = 1e-4; bf16 rtol
0.02, atol 0.1 (the packages round to bf16 at other points: ``_sdpa``
rounds the scores to bf16, the port keeps them float32).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
import repro.models.model as jax_model
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro_torch import convert
from repro_torch.configs import get_smoke_config
from repro_torch.models import layers as L
from repro_torch.models import model as M

ENCDEC, VLM = "seamless-m4t-medium", "internvl2-76b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.02, atol=0.1)}
B, S = 2, 64


@pytest.fixture(params=sorted(TOL))
def dtype(request, monkeypatch):
    """(the torch dtype, its tolerance), with the JAX package computing in
    that dtype."""
    jdt = jnp.float32 if request.param == "float32" else jnp.bfloat16
    monkeypatch.setattr(jax_layers, "ACT_DTYPE", jdt)
    monkeypatch.setattr(jax_model, "ACT", jdt)
    return getattr(torch, request.param), TOL[request.param]


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _pair(a, dt):
    """(a on the JAX side, a on the port's side), both ``dt`` with the same
    values: ``a`` is rounded to ``dt`` once, by JAX, and carried across."""
    j = jnp.asarray(a, jnp.float32 if dt == torch.float32 else jnp.bfloat16)
    return j, torch.from_numpy(np.array(j, np.float32)).to(dt)


def _attention_weights(rng, D=64, H=4, KV=2, hd=16):
    """float32 wq/wk/wv/wo at the JAX package's attention scales."""
    shapes = dict(wq=(D, H, hd), wk=(D, KV, hd), wv=(D, KV, hd),
                  wo=(H, hd, D))
    scale = dict(wq=D ** -0.5, wk=D ** -0.5, wv=D ** -0.5,
                 wo=(H * hd) ** -0.5)
    return {k: (rng.standard_normal(s) * scale[k]).astype(np.float32)
            for k, s in shapes.items()}


def _cfg(H=4, KV=2):
    return dataclasses.replace(jax_get_smoke_config(ENCDEC), n_heads=H,
                               n_kv_heads=KV)


def _weights(p, dt):
    """(JAX's float32 weights, the port's in ``dt``) of the numpy ``p``."""
    return ({k: jnp.asarray(a) for k, a in p.items()},
            {k: torch.from_numpy(a).to(dt) for k, a in p.items()})


def test_cross_kv_matches_jax(dtype):
    """enc_out·wk and enc_out·wv at GQA 4 over 2, 24 frames."""
    dt, tol = dtype
    rng = np.random.default_rng(0)
    pj, pp = _weights(_attention_weights(rng), dt)
    ej, ep = _pair(rng.standard_normal((B, 24, 64)), dt)
    kj, vj = jax_layers.cross_kv(pj, ej, _cfg())
    kp, vp = L.cross_kv(pp, ep)
    assert kp.shape == vp.shape == (B, 24, 2, 16) and kp.dtype == dt
    np.testing.assert_allclose(_np(kp), _np(kj), **tol)
    np.testing.assert_allclose(_np(vp), _np(vj), **tol)


@pytest.mark.parametrize("Sq,S_enc", [(9, 24), (1, 40), (64, 64)])
def test_cross_attention_matches_jax(dtype, Sq, S_enc):
    """``apply_attention(cross_kv=...)``: 9, 1 (a decode step) and 64
    decoder rows at positions 37 onwards against 24, 40 and 64 frames. The
    JAX package puts no RoPE on the cross q (nor on k, v): the port is
    handed the positions' RoPE and must not apply it (away from position 0
    a rotated q gives other values)."""
    dt, tol = dtype
    rng = np.random.default_rng(Sq + S_enc)
    cfg = _cfg()
    pj, pp = _weights(_attention_weights(rng), dt)
    xj, xp = _pair(rng.standard_normal((B, Sq, 64)), dt)
    ej, ep = _pair(rng.standard_normal((B, S_enc, 64)) * 0.5, dt)
    pos = np.arange(37, 37 + Sq)
    yj, _ = jax_layers.apply_attention(
        pj, xj, cfg, jnp.broadcast_to(jnp.asarray(pos)[None], (B, Sq)),
        cross_kv=jax_layers.cross_kv(pj, ej, cfg))
    yp = L.apply_attention(pp, xp, L.rope_for(torch.from_numpy(pos), cfg),
                           cross_kv=L.cross_kv(pp, ep))
    assert yp.shape == (B, Sq, 64)
    np.testing.assert_allclose(_np(yp), _np(yj), **tol)


@pytest.mark.parametrize("H,KV", [(4, 4), (4, 2)])
def test_noncausal_self_attention_matches_jax(dtype, H, KV):
    """``apply_attention(causal=False)``, RoPE at positions 0 … 39, MHA (the
    encoder-decoder's) and GQA; the causal output differs from it."""
    dt, tol = dtype
    rng = np.random.default_rng(H + KV)
    cfg = _cfg(H, KV)
    pj, pp = _weights(_attention_weights(rng, H=H, KV=KV), dt)
    xj, xp = _pair(rng.standard_normal((B, 40, 64)), dt)
    positions = jnp.broadcast_to(jnp.arange(40)[None], (B, 40))
    rope = L.rope_for(torch.arange(40), cfg)
    yj, _ = jax_layers.apply_attention(pj, xj, cfg, positions, causal=False)
    yp = L.apply_attention(pp, xp, rope, causal=False)
    np.testing.assert_allclose(_np(yp), _np(yj), **tol)
    causal = L.apply_attention(pp, xp, rope, causal=True)
    assert not np.allclose(_np(causal), _np(yp), **tol)


def _encdec(enc_layers=None, key=0, dt=torch.float32):
    """(JAX cfg, JAX params, the port's model with JAX's weights) of the
    encoder-decoder smoke config, its encoder depth set."""
    cfg = jax_get_smoke_config(ENCDEC)
    pcfg = get_smoke_config(ENCDEC)
    if enc_layers is not None:
        cfg = dataclasses.replace(cfg, enc_layers=enc_layers)
        pcfg = dataclasses.replace(pcfg, enc_layers=enc_layers)
    params = jax_model.init_params(cfg, jax.random.PRNGKey(key))
    model = convert.lm_params(jax.tree.map(np.asarray, params), pcfg,
                              device="cpu", dtype=dt)
    return cfg, params, model


@pytest.mark.parametrize("S_enc", [40, 64])
def test_encode_matches_jax(dtype, S_enc):
    """``_encode`` of S_enc frames (normal × 0.05 in bf16, as the JAX
    package's tests draw them) through the smoke config's 2 encoder
    layers and ``enc_norm``."""
    dt, tol = dtype
    cfg, params, model = _encdec(dt=dt)
    rng = np.random.default_rng(S_enc)
    frames = jnp.asarray(rng.normal(size=(B, S_enc, cfg.d_model)) * 0.05,
                         jnp.bfloat16)
    oj = jax_model._encode(params, cfg, frames)
    op = M._encode(model, torch.from_numpy(np.array(frames, np.float32))
                   .to(torch.bfloat16))
    assert op.shape == (B, S_enc, cfg.d_model) and op.dtype == dt
    np.testing.assert_allclose(_np(op), _np(oj), **tol)


def test_lm_params_maps_encoder_layers_one_by_one():
    """6 encoder layers, each layer's leaves of JAX's ``params["encoder"]``
    moved by a distinct amount (e + 1)/8 before the conversion, so that a
    mapping off by a multiple of 4 (JAX ties layers e and e + 4) would
    show: encoder layer e of the port holds entry e of every stacked leaf,
    ``enc_norm`` and each decoder layer's ``norm_x`` and ``cross`` their
    JAX counterparts, float32 bit for bit."""
    cfg = dataclasses.replace(jax_get_smoke_config(ENCDEC), enc_layers=6)
    params = jax.tree.map(np.asarray, jax_model.init_params(
        cfg, jax.random.PRNGKey(3)))
    params["encoder"] = jax.tree.map(
        lambda a: (a + np.arange(1, 7).reshape((6,) + (1,) * (a.ndim - 1))
                   / 8).astype(np.float32), params["encoder"])
    model = convert.lm_params(
        params, dataclasses.replace(get_smoke_config(ENCDEC), enc_layers=6),
        device="cpu", dtype=torch.float32)
    assert len(model.encoder) == 6
    for e, layer in enumerate(model.encoder):
        for name, p in layer.named_parameters():
            node = params["encoder"]
            for part in name.split("."):
                node = node[part]
            np.testing.assert_array_equal(p.numpy(), node[e], err_msg=name)
    for name, p in model.enc_norm.named_parameters():
        np.testing.assert_array_equal(p.numpy(), params["enc_norm"][name])
    for g, layer in enumerate(model.layers):
        for part in ("norm_x", "cross"):
            for name, p in getattr(layer, part).named_parameters():
                np.testing.assert_array_equal(
                    p.numpy(), params["groups"][0][part][name][g])


def test_init_params_ties_encoder_attention_as_jax_does():
    """With 6 encoder layers the JAX package's ``init_params`` gives layers
    e and e + 4 equal attention weights (drawn from ``keys[n_layers + e %
    4]``) and different MLPs; the port's ``init_params`` has the same tie,
    its first 4 layers' attention weights all distinct."""
    cfg = dataclasses.replace(jax_get_smoke_config(ENCDEC), enc_layers=6)
    enc = jax_model.init_params(cfg, jax.random.PRNGKey(0))["encoder"]
    model = M.init_params(dataclasses.replace(get_smoke_config(ENCDEC),
                                              enc_layers=6),
                          seed=0, device="cpu", dtype=torch.float32)
    for w in ("wq", "wk", "wv", "wo"):
        a = np.asarray(enc["attn"][w])
        ports = [layer.attn[w] for layer in model.encoder]
        for e in range(6):
            for f in range(e + 1, 6):
                tied = f == e + 4
                assert np.array_equal(a[e], a[f]) == tied, (w, e, f)
                assert torch.equal(ports[e], ports[f]) == tied, (w, e, f)
    for w in ("wup", "wdown"):
        a = np.asarray(enc["mlp"][w])
        for e in range(2):
            assert not np.array_equal(a[e], a[e + 4])
            assert not torch.equal(model.encoder[e].mlp[w],
                                   model.encoder[e + 4].mlp[w])


@pytest.mark.parametrize("n_patches", [16, 48])
def test_patch_prefix_matches_jax(dtype, n_patches):
    """The VLM's first ``n_patches`` positions replaced by the patches
    (normal × 0.05 in bf16) in ``forward`` and in ``prefill(chunks=2)``,
    whose boundary at 32 lies after 16 patches and inside 48: logits and
    every layer's k and v caches against JAX's; without the patches the
    port's logits differ."""
    dt, tol = dtype
    cfg = jax_get_smoke_config(VLM)
    params = jax_model.init_params(cfg, jax.random.PRNGKey(5))
    model = convert.lm_params(jax.tree.map(np.asarray, params),
                              get_smoke_config(VLM), device="cpu", dtype=dt)
    rng = np.random.default_rng(n_patches)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    patches = jnp.asarray(rng.normal(size=(B, n_patches, cfg.d_model))
                          * 0.05, jnp.bfloat16)
    jb = {"tokens": jnp.asarray(tokens), "patches": patches}
    tb = {"tokens": torch.from_numpy(tokens).long(),
          "patches": torch.from_numpy(np.array(patches, np.float32))}
    lj, _ = jax_model.forward(params, cfg, jb)
    lp, _ = M.forward(model, tb)
    np.testing.assert_allclose(_np(lp), _np(lj), **tol)
    plain, _ = M.forward(model, {"tokens": tb["tokens"]})
    assert not np.allclose(_np(plain[:, :n_patches]), _np(lp[:, :n_patches]),
                           **tol)
    lj, sj, _ = jax_model.prefill(params, cfg, jb, cache_len=80, chunks=2)
    lp, sp, _ = M.prefill(model, tb, cache_len=80, chunks=2)
    np.testing.assert_allclose(_np(lp), _np(lj), **tol)
    for g, (k, v) in enumerate(sp):
        kv = sj["groups"][0]["kv"]
        np.testing.assert_allclose(_np(k), _np(kv["k"][g]), **tol)
        np.testing.assert_allclose(_np(v), _np(kv["v"][g]), **tol)


def test_decode_graph_holds_the_encoder_output():
    """``DecodeGraph`` of the encoder-decoder smoke model (eager on the
    CPU): ``start`` copies the encoder output into its static buffer, and
    8 greedy steps give the tokens and last logits of 8 eager
    ``decode_step``s with ``enc_out``, bit for bit; the graph is keyed by
    the encoder output's length, and a graph without one is refused."""
    cfg, _, model = _encdec(key=1)
    rng = np.random.default_rng(9)
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, 24)))
    frames = torch.from_numpy(rng.normal(size=(B, 40, cfg.d_model)) * 0.05)
    batch = {"tokens": tokens, "frames": frames}
    enc_out = M._encode(model, frames)
    logits, state, pos = M.prefill(model, batch, cache_len=40)
    first = logits[:, -1].argmax(-1, keepdim=True)
    dec = M.compile_decode(model, B, 40, enc_len=40)
    assert M.compile_decode(model, B, 40, enc_len=40) is dec
    assert M.compile_decode(model, B, 40, enc_len=32) is not dec
    dec.start(state, first, pos, enc_out=enc_out)
    assert torch.equal(dec.enc_out, enc_out)
    tok, eager = first, []
    for i in range(8):
        lg, state = M.decode_step(model, tok, state, pos + i, enc_out=enc_out)
        tok = lg[:, -1].argmax(-1, keepdim=True)
        eager.append(tok)
    graph = []
    for _ in range(8):
        out = dec.step()
        graph.append(dec.token.clone())
    assert torch.equal(torch.cat(graph, 1), torch.cat(eager, 1))
    assert torch.equal(out, lg)
    with pytest.raises(ValueError, match="enc_len"):
        M.DecodeGraph(model, B, 40)
    with pytest.raises(ValueError, match="enc_out"):
        dec.start(state, first, pos)
