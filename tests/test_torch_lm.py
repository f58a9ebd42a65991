"""The port's LM against the JAX package on the CPU.

For each registered model — internlm2-1.8b (RMSNorm, SwiGLU), starcoder2-7b
and -15b (LayerNorm with its bias, the tanh GELU MLP), gemma-2b (MQA, GeGLU,
tied head), the mixture-of-experts granite-moe-3b-a800m (5 experts top-2
in its smoke config) and deepseek-moe-16b (a dense layer 0 of width
first_dense_ff, then 8 experts top-2 and a shared expert), the SSM
mamba2-1.3b (two SSD layers, no MLP), the hybrid jamba-v0.1-52b (its
smoke pattern ("ssm", "attn") twice, an MoE layer on the odd layers), the
encoder-decoder seamless-m4t-medium (2 encoder and 2 decoder layers with
cross-attention, LayerNorm, GELU) and the VLM internvl2-76b (GQA 4 over 2,
16 patch embeddings in front of the tokens) — the JAX package's
``init_params`` weights for its smoke config (2 to 4 layers, d_model 64 or
72) are carried across with ``repro_torch.convert.lm_params``; then
``forward`` (logits and the MoE aux loss), ``prefill`` (one chunk and two),
and four greedy ``decode_step``s of both packages run on the same
numpy-seeded tokens (and frames or patches, drawn as the JAX package's
``tests/test_models.py`` draws them; greedy decode takes each side's
``_encode`` of the frames), and each layer's decode state (k and v
caches, an SSD layer's conv window and h) is compared. Attention goes
through the flash-attention wrapper, which on the CPU runs its plain
version.

Tolerances:
- float32 (the JAX side switched to float32 by patching its two activation
  dtype globals, ``repro.models.layers.ACT_DTYPE`` and
  ``repro.models.model.ACT``, which it reads at call time): rtol = atol =
  1e-4. Both compute the same float32 function; sums run in another order
  and XLA fuses multiply-adds, which moves logits of magnitude ~4 by a few
  1e-6.
- bf16: rtol 0.02, atol 0.1. The packages round to bf16 at different
  points (``_sdpa`` rounds scores to bf16, the port keeps them float32;
  the SSD's and the SiLU's roundings are JAX's, ``layers.silu``), and one
  bf16 ulp of a logit near 4 is 0.016; over two to four layers logits
  drift by a few ulps.
  Greedy tokens are taken from JAX and fed to both, so a near tie in bf16
  cannot fork the two decodes.
- MoE routing (``routing``: every MoE layer call's router probabilities,
  recorded on both sides). In float32 every token's top-k choice of
  experts is the same on both sides. In bf16 a router near-tie may pick
  another expert, which is a different value, not a drift: the choices
  must be equal on every token whose k-th/(k+1)-th probability margin (the
  JAX side's) is at least ROUTE_MARGIN = 0.02, until the first token of a
  sequence where a choice differs (a flip, below the margin); from there on
  that sequence's inputs differ, so its logits, caches and aux loss are
  compared only before that token, and a sequence with a flip is left out
  of the last-token logits. Nothing else is loosened.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

import repro.models.layers as jax_layers
import repro.models.model as jax_model
import repro.models.moe as jax_moe
from repro.configs import SHAPES as JAX_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import get_smoke_config as jax_get_smoke_config
from repro.configs import list_archs as jax_list_archs
from repro_torch import convert
from repro_torch.configs import (SHAPES, ArchConfig, MoEConfig, SSMConfig,
                                 get_config, get_smoke_config, list_archs)
from repro_torch.models import model as M
from repro_torch.models import moe as port_moe

ARCH = "internlm2-1.8b"
ARCHS = ("internlm2-1.8b", "starcoder2-7b", "starcoder2-15b", "gemma-2b",
         "granite-moe-3b-a800m", "deepseek-moe-16b", "mamba2-1.3b",
         "jamba-v0.1-52b", "seamless-m4t-medium", "internvl2-76b")
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=0.02, atol=0.1)}
ROUTE_MARGIN = {"float32": 0.0, "bfloat16": 0.02}
B, S, CACHE = 2, 64, 80


@pytest.fixture(scope="module", params=ARCHS)
def jax_params(request):
    """(arch, JAX smoke cfg, JAX params, the params as numpy), one case a
    registered model."""
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
    return cfg, params, model, dict(TOL[name], margin=ROUTE_MARGIN[name])


@pytest.fixture
def routing(monkeypatch):
    """The router probabilities [B, S, E] of every MoE layer call, the JAX
    package's and the port's, each in call order: JAX's through a
    ``jax.debug.callback`` on the probabilities its ``apply_moe``
    computes (the same ops, which XLA computes once), the port's from
    ``moe.route``."""
    jax_rec, port_rec = [], []
    jax_apply, port_route = jax_moe.apply_moe, port_moe.route

    def recorded_apply(p, x, m, activation="swiglu"):
        probs = jax.nn.softmax(jnp.einsum(
            "bsd,de->bse", x.astype(jnp.float32), p["router"]), axis=-1)
        jax.debug.callback(lambda a: jax_rec.append(np.asarray(a)), probs,
                           ordered=True)
        return jax_apply(p, x, m, activation)

    def recorded_route(p, x, m):
        out = port_route(p, x, m)
        port_rec.append(out[0].float().numpy())
        return out

    monkeypatch.setattr(jax_moe, "apply_moe", recorded_apply)
    monkeypatch.setattr(port_moe, "route", recorded_route)
    return jax_rec, port_rec


def _first_flips(cfg, jax_rec, port_rec, offsets, margin, first=None):
    """The first position of each sequence at which the two sides' top-k
    expert choices differ (S where none does), over the recorded MoE calls,
    the i-th call's tokens at positions ``offsets[i]`` onwards. Asserts
    that the choices are equal on every token before its sequence's first
    flip whose margin between the k-th and (k+1)-th probability of the JAX
    side is at least ``margin``."""
    first = np.full(B, 10 ** 9) if first is None else first.copy()
    assert len(jax_rec) == len(port_rec) == len(offsets)
    if cfg.moe is None:
        return first
    k = cfg.moe.top_k
    for a, b, off in zip(jax_rec, port_rec, offsets):
        pos = off + np.arange(a.shape[1])
        sa = np.sort(np.argsort(-a, axis=-1)[..., :k], axis=-1)
        sb = np.sort(np.argsort(-b, axis=-1)[..., :k], axis=-1)
        srt = -np.sort(-a, axis=-1)
        gap = srt[..., k - 1] - srt[..., k]
        flip = (sa != sb).any(-1) & (pos[None, :] < first[:, None])
        assert not (flip & (gap >= margin)).any(), (gap[flip], margin)
        for bi in range(B):
            if flip[bi].any():
                first[bi] = min(first[bi], pos[flip[bi]].min())
    return first


def _tokens(seed=0, b=B, s=S):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 512, (b, s)).astype(np.int32)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else x,
                      np.float32)


N_PATCHES = 16          # tests/test_models.py:_batch's VLM prefix


def _batch(tokens, cfg, seed=0):
    """(JAX's batch, the port's) of ``tokens``: an encoder-decoder model's
    frames [B, S, D] and a VLM's patches [B, N_PATCHES, D] too, normal ×
    0.05 in bf16 as the JAX package's ``tests/test_models.py`` draws them,
    the port's the same bf16 values."""
    jb = {"tokens": jnp.asarray(tokens)}
    tb = {"tokens": torch.from_numpy(tokens).long()}
    rng = np.random.default_rng(100 + seed)
    b, s = tokens.shape
    for key, n, used in (("frames", s, cfg.enc_layers),
                         ("patches", N_PATCHES, cfg.modality == "vlm")):
        if used:
            a = jnp.asarray(rng.normal(size=(b, n, cfg.d_model)) * 0.05,
                            jnp.bfloat16)
            jb[key] = a
            tb[key] = torch.from_numpy(np.array(a, np.float32)).to(
                torch.bfloat16)
    return jb, tb


def _layer_states(jax_state):
    """The JAX package's decode state as one pair a layer, in layer order
    (DeepSeekMoE's unstacked layer 0 first, then layer prefix +
    g·len(pattern) + i from entry g of ``groups[i]``): (k, v) of an
    attention layer, (conv, h) of an SSD layer."""
    def pair(st):
        return ((st["kv"]["k"], st["kv"]["v"]) if "kv" in st
                else (st["ssm"]["conv"], st["ssm"]["h"]))
    groups = jax_state["groups"]
    G = len(jax.tree.leaves(groups[0])[0])
    return [pair(st) for st in jax_state.get("prefix", [])] + [
        tuple(a[g] for a in pair(groups[i]))
        for g in range(G) for i in range(len(groups))]


def _caches(jax_state, port_state, seqs=slice(None)):
    """(JAX's, the port's) state tensors of every layer — the k and v
    caches of an attention layer, the conv window and h of an SSD layer —
    of the sequences ``seqs``."""
    for jp, pp in zip(_layer_states(jax_state), port_state, strict=True):
        for a, b in zip(jp, pp, strict=True):
            yield _np(a)[seqs], _np(b)[seqs]


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
    """``param_count`` of every family against the JAX package's configs,
    the encoder branch included, each config rebuilt field by field from
    JAX's."""
    d = dataclasses.asdict(jax_get_config(arch))
    d["moe"] = d["moe"] and MoEConfig(**d["moe"])
    d["ssm"] = d["ssm"] and SSMConfig(**d["ssm"])
    assert ArchConfig(**d).param_count() == jax_get_config(arch).param_count()


def _unflipped(first):
    """The sequences with no flip."""
    return np.flatnonzero(first >= 10 ** 9)


def test_forward_matches_jax(pair, routing):
    cfg, params, model, tol = pair
    margin = tol.pop("margin")
    jb, tb = _batch(_tokens(), cfg)
    lj, aux_j = jax_model.forward(params, cfg, jb)
    lp, aux = M.forward(model, tb)
    assert lp.shape == (B, S, cfg.vocab_padded) and aux.dtype == torch.float32
    first = _first_flips(cfg, *routing, [0] * len(routing[0]), margin)
    for b in range(B):
        np.testing.assert_allclose(_np(lp)[b, :first[b]],
                                   _np(lj)[b, :first[b]], **tol)
    if cfg.moe is None:
        assert float(aux) == 0.0
    elif len(_unflipped(first)) == B:
        np.testing.assert_allclose(float(aux), float(aux_j), **tol)


def test_prefill_matches_jax(pair, routing):
    cfg, params, model, tol = pair
    margin = tol.pop("margin")
    jb, tb = _batch(_tokens(1), cfg, 1)
    lj, sj, pj = jax_model.prefill(params, cfg, jb, cache_len=CACHE)
    lp, sp, pp = M.prefill(model, tb, cache_len=CACHE)
    assert pp == pj == S and lp.shape == (B, 1, cfg.vocab_padded)
    seqs = _unflipped(_first_flips(cfg, *routing, [0] * len(routing[0]),
                                   margin))
    np.testing.assert_allclose(_np(lp)[seqs], _np(lj)[seqs], **tol)
    for kj, kp in _caches(sj, sp, seqs):
        np.testing.assert_allclose(kp, kj, **tol)


def test_chunked_prefill_matches_jax_and_single_shot(pair, routing):
    cfg, params, model, tol = pair
    margin = tol.pop("margin")
    jb, tb = _batch(_tokens(2), cfg, 2)
    lj, sj, _ = jax_model.prefill(params, cfg, jb, cache_len=CACHE, chunks=2)
    lp, sp, _ = M.prefill(model, tb, cache_len=CACHE, chunks=2)
    jax_rec, port_rec = routing
    calls = len(jax_rec)                    # the MoE layers, chunk by chunk
    offsets = [0] * (calls // 2) + [S // 2] * (calls // 2)
    seqs = _unflipped(_first_flips(cfg, jax_rec, port_rec[:calls], offsets,
                                   margin))
    np.testing.assert_allclose(_np(lp)[seqs], _np(lj)[seqs], **tol)
    for kj, kp in _caches(sj, sp, seqs):
        np.testing.assert_allclose(kp, kj, **tol)
    l1, s1, _ = M.prefill(model, tb, cache_len=CACHE, chunks=1)
    # the port's one-shot prefill against its chunked one, each of its MoE
    # calls against the chunks' calls of that layer
    n = len(port_rec) - calls
    chunked = [np.concatenate(port_rec[i:calls:n], axis=1) for i in range(n)]
    seqs = _unflipped(_first_flips(cfg, chunked, port_rec[calls:], [0] * n,
                                   margin))
    np.testing.assert_allclose(_np(lp)[seqs], _np(l1)[seqs], **tol)
    for one, two in zip(s1, sp, strict=True):
        for a, b in zip(one, two, strict=True):
            np.testing.assert_allclose(_np(b)[seqs], _np(a)[seqs], **tol)


def test_greedy_decode_matches_jax(pair, routing):
    cfg, params, model, tol = pair
    margin = tol.pop("margin")
    jb, tb = _batch(_tokens(3), cfg, 3)
    lj, sj, pos = jax_model.prefill(params, cfg, jb, cache_len=CACHE)
    lp, sp, _ = M.prefill(model, tb, cache_len=CACHE)
    enc_j = enc_p = None
    if cfg.enc_layers:
        enc_j = jax_model._encode(params, cfg, jb["frames"])
        enc_p = M._encode(model, tb["frames"])
    first = _first_flips(cfg, *routing, [0] * len(routing[0]), margin)
    for i in range(4):
        done = len(routing[0])
        tok = np.asarray(jnp.argmax(lj[:, -1], -1), np.int32)[:, None]
        lj, sj = jax_model.decode_step(params, cfg, jnp.asarray(tok), sj,
                                       jnp.asarray(pos + i, jnp.int32),
                                       enc_out=enc_j)
        lp, sp = M.decode_step(model, torch.tensor(tok).long(), sp,
                               pos + i, enc_out=enc_p)
        first = _first_flips(cfg, routing[0][done:], routing[1][done:],
                             [pos + i] * (len(routing[0]) - done), margin,
                             first)
        seqs = _unflipped(first)
        np.testing.assert_allclose(_np(lp)[seqs], _np(lj)[seqs], **tol)
    for kj, kp in _caches(sj, sp, seqs):
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
    _, batch = _batch(_tokens(3), model.cfg, 3)
    tokens = batch["tokens"]
    logits_full, _ = M.forward(model, batch)
    lg, state, pos = M.prefill(model, dict(batch, tokens=tokens[:, :S - 1]),
                               cache_len=S + 4)
    enc_out = M._encode(model, batch["frames"]) if "frames" in batch else None
    lg2, _ = M.decode_step(model, tokens[:, S - 1:S], state, pos,
                           enc_out=enc_out)
    a, b = _np(logits_full[:, -1]), _np(lg2[:, 0])
    assert (a.argmax(-1) == b.argmax(-1)).all()
    np.testing.assert_allclose(a, b, rtol=0.1, atol=0.25)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_prefill_matches_single_shot(arch):
    """Counterpart of the JAX package's
    ``test_chunked_prefill_matches_single_shot``, at its tolerance."""
    model = _port_bf16_model(arch, 0)
    _, batch = _batch(_tokens(0), model.cfg)
    l1, _, _ = M.prefill(model, batch, cache_len=80, chunks=1)
    l2, _, _ = M.prefill(model, batch, cache_len=80, chunks=2)
    a, b = _np(l1), _np(l2)
    assert (a.argmax(-1) == b.argmax(-1)).all()
    np.testing.assert_allclose(a, b, rtol=0.1, atol=0.2)


def test_init_params_shapes_and_scales_match_jax(jax_params):
    """The port's own random weights have JAX's shapes and scales (std
    within 10% of JAX's for each drawn weight; the bits differ by design).
    Norm scales and biases and the SSD's D, dt_bias and conv_b equal JAX's
    exactly. The SSD's A_log = log(linspace(1, 16, H)) is held within 2
    float32 ulps: XLA's float32 division and log on the CPU are not
    correctly rounded (its eager and jitted A_log already differ in the last
    bit), so torch cannot repeat its bits; measured: 1 ulp at H 8 and 64, 2
    at H 128, jamba's, on a few entries."""
    arch, _, _, np_params = jax_params
    ref = convert.lm_params(np_params, get_smoke_config(arch), device="cpu",
                            dtype=torch.float32)
    own = M.init_params(get_smoke_config(arch), seed=0, device="cpu",
                        dtype=torch.float32)
    mine = dict(own.named_parameters())
    for name, p in ref.named_parameters():
        assert mine[name].shape == p.shape, name
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("scale", "bias", "D", "dt_bias", "conv_b"):
            assert torch.equal(mine[name], p), name
        elif leaf == "A_log":
            np.testing.assert_array_max_ulp(mine[name].numpy(), p.numpy(),
                                            maxulp=2)
        else:
            assert abs(float(mine[name].std() / p.std()) - 1) < 0.1, name


def test_lm_params_maps_pattern_groups_layer_by_layer():
    """jamba-v0.1-52b-smoke's pattern ("ssm", "attn") over 4 layers: the
    JAX package stacks one dict a pattern position, ``groups[i]`` [G, ...],
    and layer 2g + i of the port holds entry g of ``groups[i]``, every
    weight, float32 bit for bit (an SSD layer with its MLP, an attention
    layer with its MoE)."""
    cfg = jax_get_smoke_config("jamba-v0.1-52b")
    params = jax.tree.map(np.asarray, jax_model.init_params(
        cfg, jax.random.PRNGKey(2)))
    pat = cfg.layer_pattern()
    assert pat == ("ssm", "attn") and len(params["groups"]) == 2
    model = convert.lm_params(params, get_smoke_config("jamba-v0.1-52b"),
                              device="cpu", dtype=torch.float32)
    kinds = []
    for layer_idx, layer in enumerate(model.layers):
        g, i = divmod(layer_idx, len(pat))
        kinds.append(layer.kind)
        assert layer.kind == pat[i]
        assert (layer.moe is not None) == (layer_idx % 2 == 1)
        for name, p in layer.named_parameters():
            node = params["groups"][i]
            for part in name.split("."):
                node = node[part]
            np.testing.assert_array_equal(p.numpy(), node[g], err_msg=name)
    assert kinds == ["ssm", "attn", "ssm", "attn"]


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
    0 before ``convert.lm_params`` carries the weights across — the
    cross-attention's ``norm_x``, the encoder layers' norms and
    ``enc_norm`` included: the port's float32 forward still equals JAX's
    within the float32 tolerance, so each scale and bias reaches the layer
    that reads it."""
    monkeypatch.setattr(jax_layers, "ACT_DTYPE", jnp.float32)
    monkeypatch.setattr(jax_model, "ACT", jnp.float32)
    cfg = jax_get_smoke_config(arch)
    params = jax.tree.map(np.asarray, jax_model.init_params(
        cfg, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(14)
    norms = [params["final_norm"]] + [layer[k] for layer in (
        *params["groups"], *params.get("prefix", ()),
        *([params["encoder"]] if "encoder" in params else ()))
        for k in ("norm1", "norm2", "norm_x") if k in layer]
    if "enc_norm" in params:
        norms.append(params["enc_norm"])
    for norm in norms:
        for name, a in norm.items():
            base = 1.0 if name == "scale" else 0.0
            norm[name] = (base + 0.3 * rng.standard_normal(a.shape)
                          ).astype(np.float32)
    assert ("bias" in norms[0]) == (cfg.norm == "layernorm")
    model = convert.lm_params(params, get_smoke_config(arch), device="cpu",
                              dtype=torch.float32)
    jb, tb = _batch(_tokens(4), cfg, 4)
    lj, _ = jax_model.forward(jax.tree.map(jnp.asarray, params), cfg, jb)
    lp, _ = M.forward(model, tb)
    np.testing.assert_allclose(_np(lp), _np(lj), **TOL["float32"])
