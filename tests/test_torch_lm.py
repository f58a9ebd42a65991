"""The port's dense LM against the JAX package on the CPU.

For each registered dense model — internlm2-1.8b (RMSNorm, SwiGLU) and
starcoder2-7b and -15b (LayerNorm with its bias, the tanh GELU MLP) — the
JAX package's ``init_params`` weights for its smoke config (2 layers,
d_model 64 or 72, 4 heads over 2 KV heads or 6 over 2) are carried across
with ``repro_torch.convert.lm_params``; then ``forward``, ``prefill`` (one
chunk and two), and four greedy ``decode_step``s of both packages run on the
same numpy-seeded tokens. Attention goes through the flash-attention
wrapper, which on the CPU runs its plain version.

Tolerances:
- float32 (the JAX side switched to float32 by patching its two activation
  dtype globals, ``repro.models.layers.ACT_DTYPE`` and
  ``repro.models.model.ACT``, which it reads at call time): rtol = atol =
  1e-4. Both compute the same float32 function; sums run in another order
  and XLA fuses multiply-adds, which moves logits of magnitude ~4 by a few
  1e-6.
- bf16: rtol 0.02, atol 0.1. The packages round to bf16 at different
  points (``_sdpa`` rounds scores to bf16, the port keeps them float32;
  XLA and torch round the MLP's silu at different places), and one bf16 ulp
  of a logit near 4 is 0.016; over two layers logits drift by a few ulps.
  Greedy tokens are taken from JAX and fed to both, so a near tie in bf16
  cannot fork the two decodes.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
import repro.models.model as jax_model
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs import list_archs as jax_list_archs
from repro_torch import convert
from repro_torch.configs import (SHAPES, ArchConfig, MoEConfig, SSMConfig,
                                 get_config, get_smoke_config, list_archs)
from repro_torch.models import model as M

ARCH = "internlm2-1.8b"
ARCHS = ("internlm2-1.8b", "starcoder2-7b", "starcoder2-15b")
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.02, atol=0.1)}
B, S, CACHE = 2, 64, 80


@pytest.fixture(scope="module", params=ARCHS)
def jax_params(request):
    """(arch, JAX smoke cfg, JAX params, the params as numpy), one case a
    registered dense model."""
    cfg = jax_get_smoke_config(request.param)
    params = jax_model.init_params(cfg, jax.random.PRNGKey(0))
    return request.param, cfg, params, jax.tree.map(np.asarray, params)


@pytest.fixture(params=sorted(TOL))
def pair(request, jax_params, monkeypatch):
    """(JAX cfg, JAX params, the port's model with the same weights, the
    dtype's tolerance), with both packages computing in that dtype."""
    name = request.param
    jdt = jnp.float32 if name == "float32" else jnp.bfloat16
    monkeypatch.setattr(jax_layers, "ACT_DTYPE", jdt)
    monkeypatch.setattr(jax_model, "ACT", jdt)
    arch, cfg, params, np_params = jax_params
    model = convert.lm_params(np_params, get_smoke_config(arch),
                              device="cpu", dtype=getattr(torch, name))
    return cfg, params, model, TOL[name]


def _tokens(seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


def _batch(tokens):
    return ({"tokens": jnp.asarray(tokens)},
            {"tokens": torch.from_numpy(tokens).long()})


def _caches(jax_state, port_state):
    kv = jax_state["groups"][0]["kv"]
    for i, name in enumerate(("k", "v")):
        yield (_np(kv[name]),
               _np(torch.stack([c[i] for c in port_state])))


def test_configs_match_jax():
    assert set(ARCHS) <= set(list_archs())
    for arch in list_archs():
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(jax_get_config(arch)))
        assert (dataclasses.asdict(get_smoke_config(arch))
                == dataclasses.asdict(jax_get_smoke_config(arch)))
        assert (get_config(arch).param_count()
                == jax_get_config(arch).param_count())
    assert ({k: dataclasses.asdict(v) for k, v in SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in JAX_SHAPES.items()})


@pytest.mark.parametrize("arch", jax_list_archs())
def test_param_count_matches_jax_every_family(arch):
    """``param_count``'s MoE, SSM and encoder branches, which no registered
    arch of the port reaches yet, against the JAX package's configs."""
    d = dataclasses.asdict(jax_get_config(arch))
    d["moe"] = d["moe"] and MoEConfig(**d["moe"])
    d["ssm"] = d["ssm"] and SSMConfig(**d["ssm"])
    assert ArchConfig(**d).param_count() == jax_get_config(arch).param_count()


def test_forward_matches_jax(pair):
    cfg, params, model, tol = pair
    jb, tb = _batch(_tokens())
    lj, _ = jax_model.forward(params, cfg, jb)
    lp, aux = M.forward(model, tb)
    assert lp.shape == (B, S, cfg.vocab_padded) and float(aux) == 0.0
    np.testing.assert_allclose(_np(lp), _np(lj), **tol)


def test_prefill_matches_jax(pair):
    cfg, params, model, tol = pair
    jb, tb = _batch(_tokens(1))
    lj, sj, pj = jax_model.prefill(params, cfg, jb, cache_len=CACHE)
    lp, sp, pp = M.prefill(model, tb, cache_len=CACHE)
    assert pp == pj == S and lp.shape == (B, 1, cfg.vocab_padded)
    np.testing.assert_allclose(_np(lp), _np(lj), **tol)
    for kj, kp in _caches(sj, sp):
        np.testing.assert_allclose(kp, kj, **tol)


def test_chunked_prefill_matches_jax_and_single_shot(pair):
    cfg, params, model, tol = pair
    jb, tb = _batch(_tokens(2))
    lj, sj, _ = jax_model.prefill(params, cfg, jb, cache_len=CACHE, chunks=2)
    lp, sp, _ = M.prefill(model, tb, cache_len=CACHE, chunks=2)
    np.testing.assert_allclose(_np(lp), _np(lj), **tol)
    for kj, kp in _caches(sj, sp):
        np.testing.assert_allclose(kp, kj, **tol)
    l1, s1, _ = M.prefill(model, tb, cache_len=CACHE, chunks=1)
    np.testing.assert_allclose(_np(lp), _np(l1), **tol)
    for (a, _), (b, _) in zip(s1, sp):
        np.testing.assert_allclose(_np(b), _np(a), **tol)


def test_greedy_decode_matches_jax(pair):
    cfg, params, model, tol = pair
    jb, tb = _batch(_tokens(3))
    lj, sj, pos = jax_model.prefill(params, cfg, jb, cache_len=CACHE)
    lp, sp, _ = M.prefill(model, tb, cache_len=CACHE)
    for i in range(4):
        tok = np.asarray(jnp.argmax(lj[:, -1], -1), np.int32)[:, None]
        lj, sj = jax_model.decode_step(params, cfg, jnp.asarray(tok), sj,
                                       jnp.asarray(pos + i, jnp.int32))
        lp, sp = M.decode_step(model, torch.tensor(tok).long(), sp,
                               pos + i)
        np.testing.assert_allclose(_np(lp), _np(lj), **tol)
    for kj, kp in _caches(sj, sp):
        np.testing.assert_allclose(kp, kj, **tol)


def _port_bf16_model(arch, seed):
    return M.init_params(get_smoke_config(arch), seed=seed, device="cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_decode_matches_forward(arch):
    """The port's own counterpart of the JAX package's
    ``test_prefill_decode_matches_forward``: greedy next-token from (prefill
    S−1 → decode 1) equals the next-token from the full forward, in bf16,
    at that test's tolerance (rtol 0.1, atol 0.25)."""
    model = _port_bf16_model(arch, 1)
    tokens = torch.from_numpy(_tokens(3)).long()
    logits_full, _ = M.forward(model, {"tokens": tokens})
    lg, state, pos = M.prefill(model, {"tokens": tokens[:, :S - 1]},
                               cache_len=S + 4)
    lg2, _ = M.decode_step(model, tokens[:, S - 1:S], state, pos)
    a, b = _np(logits_full[:, -1]), _np(lg2[:, 0])
    assert (a.argmax(-1) == b.argmax(-1)).all()
    np.testing.assert_allclose(a, b, rtol=0.1, atol=0.25)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_single_shot(arch):
    """Counterpart of the JAX package's
    ``test_chunked_prefill_matches_single_shot``, at its tolerance."""
    model = _port_bf16_model(arch, 0)
    batch = {"tokens": torch.from_numpy(_tokens(0)).long()}
    l1, _, _ = M.prefill(model, batch, cache_len=80, chunks=1)
    l2, _, _ = M.prefill(model, batch, cache_len=80, chunks=2)
    a, b = _np(l1), _np(l2)
    assert (a.argmax(-1) == b.argmax(-1)).all()
    np.testing.assert_allclose(a, b, rtol=0.1, atol=0.2)


def test_init_params_shapes_and_scales_match_jax(jax_params):
    """The port's own random weights have JAX's shapes and scales (std
    within 10% of JAX's for each weight; the bits differ by design)."""
    arch, _, _, np_params = jax_params
    ref = convert.lm_params(np_params, get_smoke_config(arch), device="cpu",
                            dtype=torch.float32)
    own = M.init_params(get_smoke_config(arch), seed=0, device="cpu",
                        dtype=torch.float32)
    mine = dict(own.named_parameters())
    for name, p in ref.named_parameters():
        assert mine[name].shape == p.shape, name
        if name.endswith(("scale", "bias")):
            assert torch.equal(mine[name], p), name
        else:
            assert abs(float(mine[name].std() / p.std()) - 1) < 0.1, name


@pytest.mark.parametrize("change", [
    dict(family="moe", moe=MoEConfig(n_experts=4, top_k=2, d_expert=32)),
    dict(family="ssm", ssm=SSMConfig()),
    dict(family="hybrid", pattern=("attn", "ssm"), ssm=SSMConfig()),
    dict(family="encdec", enc_layers=2),
    dict(modality="vlm"),
])
def test_unsupported_families_raise(change):
    cfg: ArchConfig = dataclasses.replace(get_smoke_config(ARCH), **change)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        M.LM(cfg, device="cpu")


def _draw(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_jax(kind):
    """Float32, rtol = atol = 1e-5: the same reductions in another order."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(11)
    x, scale, bias = _draw(rng, 3, 5, 64), _draw(rng, 64), _draw(rng, 64)
    ref = jax_layers.apply_norm({"scale": jnp.asarray(scale),
                                 "bias": jnp.asarray(bias)},
                                jnp.asarray(x), kind)
    out = L.apply_norm({"scale": torch.tensor(scale),
                        "bias": torch.tensor(bias)}, torch.tensor(x), kind)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("activation", ["swiglu", "geglu", "gelu"])
def test_mlp_matches_jax(activation):
    """Float32, rtol = atol = 1e-5 (gelu in its tanh form on both sides)."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(12)
    p = {"wup": _draw(rng, 64, 96) / 8, "wdown": _draw(rng, 96, 64) / 8,
         "wgate": _draw(rng, 64, 96) / 8}
    x = _draw(rng, 2, 7, 64)
    ref = jax_layers.apply_mlp({k: jnp.asarray(a) for k, a in p.items()},
                               jnp.asarray(x), activation)
    out = L.apply_mlp({k: torch.tensor(a) for k, a in p.items()},
                      torch.tensor(x), activation)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)


def test_rope_and_tied_head_match_jax():
    """RoPE at positions 37…49 and the tied LM head (x · tokᵀ), float32,
    rtol = atol = 1e-5."""
    from repro_torch.models import layers as L
    rng = np.random.default_rng(13)
    x = _draw(rng, 2, 13, 4, 16)
    pos = np.arange(37, 50)
    cos, sin = jax_layers.rope_angles(jnp.asarray(pos)[None], 16, 10000.0)
    ref = jax_layers.apply_rope(jnp.asarray(x), cos[:, :, None, :],
                                sin[:, :, None, :])
    out = L.apply_rope(torch.tensor(x), *L.rope_for(
        torch.tensor(pos), get_smoke_config(ARCH)))
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)
    tok, h = _draw(rng, 48, 16), _draw(rng, 2, 3, 16)
    ref = jax_layers.apply_lm_head({"tok": jnp.asarray(tok)}, None,
                                   jnp.asarray(h), tie=True)
    out = L.apply_lm_head({"tok": torch.tensor(tok)}, None, torch.tensor(h),
                          tie=True)
    np.testing.assert_allclose(_np(out), _np(ref), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_with_drawn_norms_matches_jax(arch, monkeypatch):
    """Every norm's scale (and LayerNorm's bias) drawn away from JAX's 1 and
    0 before ``convert.lm_params`` carries the weights across: the port's
    float32 forward still equals JAX's within the float32 tolerance, so
    each scale and bias reaches the layer that reads it."""
    monkeypatch.setattr(jax_layers, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(jax_model, "ACT", jnp.float32)
    cfg = jax_get_smoke_config(arch)
    params = jax.tree.map(np.asarray, jax_model.init_params(
        cfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(14)
    norms = [params["final_norm"]] + [params["groups"][0][k]
                                      for k in ("norm1", "norm2")]
    for norm in norms:
        for name, a in norm.items():
            base = 1.0 if name == "scale" else 0.0
            norm[name] = (base + 0.3 * rng.standard_normal(a.shape)
                          ).astype(np.float32)
    assert ("bias" in norms[0]) == (cfg.norm == "layernorm")
    model = convert.lm_params(params, get_smoke_config(arch), device="cpu",
                              dtype=torch.float32)
    jb, tb = _batch(_tokens(4))
    lj, _ = jax_model.forward(jax.tree.map(jnp.asarray, params), cfg, jb)
    lp, _ = M.forward(model, tb)
    np.testing.assert_allclose(_np(lp), _np(lj), **TOL["float32"])
