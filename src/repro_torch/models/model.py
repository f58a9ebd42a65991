"""The LM: weights, forward, prefill and greedy decode.

Ported from the JAX package's ``models/model.py`` for every family it
registers: dense, mixture-of-experts, SSM, hybrid, encoder-decoder and
VLM. Each decoder layer is an attention or an SSD layer (``ssm.py``), by
its position in ``cfg.layer_pattern()``, then, in an encoder-decoder
model's attention layers, cross-attention over the encoder output, then
an MLP or an MoE layer (``moe.py``) where the JAX package gives one (every
attention layer, and the SSD layers of a family other than "ssm"):
``init_params``, ``forward``, ``prefill`` (chunked prefill included) and
``decode_step``. An encoder-decoder model (``cfg.enc_layers``) runs its
``EncoderLayer``s over ``batch["frames"]`` (precomputed audio-frame
embeddings [B, S_enc, D], the JAX package's stub frontend) in ``_encode``,
non-causal with RoPE; a VLM (``cfg.modality == "vlm"``) takes
``batch["patches"]`` [B, n, D] (``VLM_PATCHES`` in the JAX package's input
specs, its stub frontend) in place of the first n embedded tokens. The
weights live in ``nn.Module``s, one ``DecoderLayer`` per layer (and one
``EncoderLayer`` an encoder layer), and the layers are looped
over in Python where the JAX package scans over stacked weights (one
stack a position of the pattern; DeepSeekMoE's dense layer 0 is a prefix
outside the scan: here it is layer 0 with an MLP of width
``first_dense_ff``). Every weight keeps the JAX layout (``wq [D,H,hd]``,
``wo [H,hd,D]``, ``wup [D,F]``, the experts' ``wup [E,D,F]``, the SSD's
``w_x [D,d_inner]`` …), so ``repro_torch.convert.lm_params`` is a copy
without reshapes.

The decode state is one pair of tensors a layer, updated in place: the
(k, v) caches [B, cache_len, KV, hd] of an attention layer, the (conv, h)
state of an SSD layer (``ssm.init_ssm_state``). ``decode_step`` takes
``pos`` as an int32 device scalar, as the JAX package's does: the cache row
is written at it and attention masks the keys past it on the device.
``DecodeGraph``, built once per (model, batch, cache_len, encoder output
length) by ``compile_decode``, is the counterpart of
``jax.jit(decode_step, donate_argnums=…)``: one greedy step over static
token, position and cache buffers, captured as a CUDA graph on the card and
replayed; it writes the greedy token back and advances the position on the
device (an encoder-decoder model's graph also holds the encoder output in
a static buffer). ``prefill`` stays eager, encodes the frames once for
every chunk, and carries the SSD state from one chunk to the next.

Under a mesh (``parallel.sharding.use_shardings``) each rank holds its
blocks of the weights (``param_specs``, cut by ``sharding.shard_model``)
and its rows of the batch, and ``forward``/``loss_fn`` run the sharded
form (``_Par``): Megatron TP over the model axis (heads, the MLP's and
the SSD's columns, the vocabulary), EP or expert TP in MoE layers,
sequence parallelism with ``rules.seq``, and the loss's sums over the
batch axes; the collectives are ``parallel/comm.py``'s. Without rules the
code is the single-device path, unchanged.

Training: ``loss_fn`` (cross-entropy plus the weighted MoE aux loss) runs
``forward(..., train=True, remat=...)``. The weights are built with
``requires_grad=False``, so serving builds no autograd graph; the trainer
(``train.train_step.init_train_state``) turns gradients on, and
``prefill``, ``decode_step`` and the ``DecodeGraph`` step run under
``torch.no_grad()`` whatever the weights say.
"""
from __future__ import annotations

import functools

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.models import layers as L
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.parallel import comm
from repro_torch.parallel.sharding import (_batch_spec, active, block_range,
                                           current_rules, decode_state_specs,
                                           dim_range, gather_leaf, spec_axes)
from repro_torch.utils.cuda_graph import StepGraph
from repro_torch.utils.device import resolve_device

VLM_PATCHES = 256        # stub frontend: patch embeddings prefix length


def _use_moe(cfg: ArchConfig, layer: int) -> bool:
    """Whether layer ``layer`` holds an MoE layer (the JAX package's rule:
    every ``every``-th layer, but not a dense layer 0)."""
    m = cfg.moe
    if m is None or (layer == 0 and m.first_dense_ff):
        return False
    return layer % m.every == m.every - 1


def _weights(dtype, dev, **shapes) -> nn.ParameterDict:
    return nn.ParameterDict({
        k: nn.Parameter(torch.empty(s, dtype=dtype, device=dev),
                        requires_grad=False) for k, s in shapes.items()})


def _norm(cfg: ArchConfig, dev) -> nn.ParameterDict:
    shapes = dict(scale=(cfg.d_model,))
    if cfg.norm == "layernorm":
        shapes["bias"] = (cfg.d_model,)
    return _weights(torch.float32, dev, **shapes)


def _attention(cfg: ArchConfig, dtype, dev) -> nn.ParameterDict:
    """wq [D, H, hd], wk/wv [D, KV, hd], wo [H, hd, D]: self-attention's,
    and cross-attention's (the JAX package's ``init_cross_attention`` is
    ``init_attention``)."""
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    return _weights(dtype, dev, wq=(D, H, hd), wk=(D, KV, hd),
                    wv=(D, KV, hd), wo=(H, hd, D))


def _mlp(cfg: ArchConfig, width: int, dtype, dev) -> nn.ParameterDict:
    D = cfg.d_model
    shapes = dict(wup=(D, width), wdown=(width, D))
    if cfg.activation in ("swiglu", "geglu"):
        shapes["wgate"] = (D, width)
    return _weights(dtype, dev, **shapes)


class DecoderLayer(nn.Module):
    """One pre-norm residual layer: attention or an SSD layer (``kind``,
    the layer's position in ``cfg.layer_pattern()``), then, in an
    encoder-decoder model's attention layers, cross-attention (``norm_x``
    and ``cross``, None elsewhere), then, where the JAX package gives one
    (``norm2`` is None elsewhere), the MLP or the MoE layer (``_use_moe``);
    DeepSeekMoE's layer 0 takes an MLP of width ``first_dense_ff``."""

    def __init__(self, cfg: ArchConfig, layer: int, dtype, dev):
        super().__init__()
        D, F = cfg.d_model, cfg.d_ff
        pat = cfg.layer_pattern()
        self.kind = pat[layer % len(pat)]
        self.norm1 = _norm(cfg, dev)
        self.attn = self.ssm = self.norm2 = self.mlp = self.moe = None
        self.norm_x = self.cross = None
        if self.kind == "attn":
            self.attn = _attention(cfg, dtype, dev)
        else:
            self.ssm = SSM.SSM(cfg, dtype, dev)
        if cfg.enc_layers and self.kind == "attn":
            self.norm_x = _norm(cfg, dev)
            self.cross = _attention(cfg, dtype, dev)
        if self.kind != "attn" and cfg.family == "ssm":
            return
        self.norm2 = _norm(cfg, dev)
        if _use_moe(cfg, layer):
            self.moe = MOE.MoE(D, cfg.moe, dtype, dev)
            return
        if layer == 0 and cfg.moe is not None and cfg.moe.first_dense_ff:
            F = cfg.moe.first_dense_ff
        self.mlp = _mlp(cfg, F, dtype, dev) if F else None


class EncoderLayer(nn.Module):
    """One pre-norm residual layer of an encoder-decoder model's encoder:
    non-causal self-attention, then an MLP of width ``d_ff``; no
    cross-attention."""

    def __init__(self, cfg: ArchConfig, dtype, dev):
        super().__init__()
        self.norm1 = _norm(cfg, dev)
        self.attn = _attention(cfg, dtype, dev)
        self.norm2 = _norm(cfg, dev)
        self.mlp = _mlp(cfg, cfg.d_ff, dtype, dev)


class LM(nn.Module):
    """Embedding, ``n_layers`` decoder layers, final norm and LM head; an
    encoder-decoder model also holds ``encoder``, its ``enc_layers``
    encoder layers, and ``enc_norm`` (None elsewhere). The activation dtype
    (bf16 by default; the JAX package's ``REPRO_ACT_DTYPE``) is the dtype
    of every matmul weight."""

    def __init__(self, cfg: ArchConfig, *, dtype=torch.bfloat16, device=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg, self.dtype, self.device = cfg, dtype, dev
        D, V = cfg.d_model, cfg.vocab_padded
        self.embed = _weights(dtype, dev, tok=(V, D))
        self.final_norm = _norm(cfg, dev)
        self.lm_head = (None if cfg.tie_embeddings
                        else _weights(dtype, dev, w=(D, V)))
        self.layers = nn.ModuleList(DecoderLayer(cfg, i, dtype, dev)
                                    for i in range(cfg.n_layers))
        self.encoder = self.enc_norm = None
        if cfg.enc_layers:
            self.encoder = nn.ModuleList(EncoderLayer(cfg, dtype, dev)
                                         for _ in range(cfg.enc_layers))
            self.enc_norm = _norm(cfg, dev)


def init_params(cfg: ArchConfig, seed: int = 0, device=None,
                dtype=torch.bfloat16) -> LM:
    """A model with random weights of the JAX package's shapes and scales
    (normal with std D^-½ for wq/wk/wv/wup/wgate, the MoE router, the
    embedding, the LM head and the SSD's input projections, (H·hd)^-½ for
    wo, d_inner^-½ for the SSD's w_out, 0.5 for its conv_w, and F^-½ for a
    wdown of F rows: the MLP's d_ff, an expert's d_expert, the shared
    experts' n_shared·d_expert, the dense layer 0's first_dense_ff; norm
    scales 1, biases 0; the SSD's dt_bias and conv_b 0, D 1 and A_log =
    log(linspace(1, 16, H)), as ``init_ssm`` makes them), drawn in float32
    by a ``torch.Generator`` on ``device`` from ``seed``. The bits are not
    JAX's: ``convert.lm_params`` carries JAX's weights across.

    Cross-attention and the encoder's attention take the attention
    scales, the encoder's MLP the MLP scales. As in the JAX package, which
    draws encoder layer e's attention from ``keys[n_layers + e % 4]``,
    only 4 sets of encoder attention weights are drawn: layer e holds a
    copy of set ``e % 4``, so layers e and e + 4 have equal attention
    weights (their MLPs differ). The JAX package is the reference, so the
    port keeps the tie."""
    model = LM(cfg, dtype=dtype, device=device)
    gen = torch.Generator(device=model.device).manual_seed(seed)
    D, Hhd = cfg.d_model, cfg.n_heads * cfg.hd
    std = dict(wq=D ** -0.5, wk=D ** -0.5, wv=D ** -0.5, wup=D ** -0.5,
               wgate=D ** -0.5, router=D ** -0.5, tok=D ** -0.5,
               w=D ** -0.5, w_z=D ** -0.5, w_x=D ** -0.5, w_B=D ** -0.5,
               w_C=D ** -0.5, w_dt=D ** -0.5, conv_w=0.5)
    if Hhd:
        std["wo"] = Hhd ** -0.5
    if cfg.ssm is not None:
        std["w_out"] = SSM.dims(cfg)[0] ** -0.5
    for name, p in model.named_parameters():
        leaf = name.rsplit(".", 1)[-1]
        if _tied_encoder_attention(name):
            continue
        if leaf in ("scale", "D"):
            p.fill_(1.0)
        elif leaf in ("bias", "dt_bias", "conv_b"):
            p.zero_()
        elif leaf == "A_log":
            p.copy_(SSM.a_log_init(p.shape[0], model.device))
        else:
            x = torch.randn(p.shape, generator=gen, dtype=torch.float32,
                            device=model.device)
            p.copy_(x.mul_(p.shape[-2] ** -0.5 if leaf == "wdown"
                           else std[leaf]))
    for e in range(4, cfg.enc_layers):
        model.encoder[e].attn.load_state_dict(
            model.encoder[e % 4].attn.state_dict())
    return model


def _tied_encoder_attention(name: str) -> bool:
    """Whether the parameter ``name`` is an attention weight of encoder
    layer 4 or later, which ``init_params`` copies from layer ``e % 4``."""
    parts = name.split(".")
    return parts[0] == "encoder" and int(parts[1]) >= 4 and parts[2] == "attn"


def param_specs(cfg: ArchConfig, rules) -> dict:
    """{parameter name: spec} for ``cfg``'s LM — the JAX package's
    ``param_specs`` by the port's names, each layer's without the scan's
    leading group axis: the embedding ``(tp, None)``, the LM head ``(None,
    tp)``, norms whole, attention (and cross-attention, and the encoder's)
    by ``layers.attention_param_specs``, MLPs by ``mlp_param_specs``, MoE
    layers by ``moe.moe_param_specs``, SSD layers by
    ``ssm.ssm_param_specs``."""
    att = L.attention_param_specs(cfg, rules)
    mlp = L.mlp_param_specs(cfg.activation, rules)
    ssm = SSM.ssm_param_specs(cfg, rules) if cfg.ssm is not None else {}
    moe = MOE.moe_param_specs(cfg.moe, rules) if cfg.moe is not None else {}
    out = {}
    for name, p in LM(cfg, device="meta").named_parameters():
        parts = name.split(".")
        leaf, owner = parts[-1], parts[-2]
        if parts[0] == "embed":
            spec = (rules.tp, None)
        elif parts[0] == "lm_head":
            spec = (None, rules.tp)
        elif owner in ("attn", "cross"):
            spec = att[leaf]
        elif owner == "mlp":
            spec = mlp[leaf]
        elif owner == "ssm":
            spec = ssm[leaf]
        elif "moe" in parts:
            spec = moe[name.split(".moe.")[1]]
        else:                            # norms
            spec = (None,) * p.dim()
        out[name] = spec
    return out


# -- forward --------------------------------------------------------------------

def _apply_sublayer(layer: DecoderLayer, x, cfg: ArchConfig, rope, *,
                    cache=None, cache_pos=None, enc_out=None, train=False,
                    par=None, srv=None):
    """Pre-norm residual layer → (x, the MoE layer's aux loss or None);
    ``cache``, the layer's state pair, is written in place. An SSD layer
    with a state takes the decode step for one token and the prefill that
    carries the state otherwise, as the JAX package's ``_apply_sublayer``
    picks them. With ``enc_out`` [B, S_enc, D], a layer with ``cross``
    attends over it after its self-attention, its keys and values
    computed from it in every call, as the JAX package computes them.
    ``train`` sends attention through ``layers.train_attention``. ``par``
    (a ``_Par``) runs the sharded layer instead, ``srv`` (a ``_Serve``)
    the sharded layer with its state."""
    if srv is not None:
        return _serve_sublayer(layer, x, cfg, rope, srv, cache, cache_pos,
                               enc_out)
    if par is not None:
        return _sharded_sublayer(layer, x, cfg, rope, par, enc_out=enc_out,
                                 train=train)
    h = L.apply_norm(layer.norm1, x, cfg.norm)
    if layer.attn is not None:
        x = x + L.apply_attention(layer.attn, h, rope, cache=cache,
                                  cache_pos=cache_pos, train=train)
        if enc_out is not None and layer.cross is not None:
            hx = L.apply_norm(layer.norm_x, x, cfg.norm)
            x = x + L.apply_attention(
                layer.cross, hx, None,
                cross_kv=L.cross_kv(layer.cross, enc_out), train=train)
    elif cache is not None:
        x = x + _ssm_with_state(layer.ssm, h, cfg, cache)
    else:
        x = x + SSM.apply_ssm(layer.ssm, h, cfg)
    aux = None
    if layer.moe is not None or layer.mlp is not None:
        h = L.apply_norm(layer.norm2, x, cfg.norm)
        if layer.moe is not None:
            y, aux = MOE.apply_moe(layer.moe, h, cfg.moe, cfg.activation)
        else:
            y = L.apply_mlp(layer.mlp, h, cfg.activation)
        x = x + y
    return x, aux


def _ssm_with_state(p, h, cfg: ArchConfig, cache):
    """An SSD layer with its state pair ``cache``, written in place: the
    decode step for one token, else the prefill that carries the state, as
    the JAX package's ``_apply_sublayer`` picks them → its output."""
    if h.shape[1] == 1:
        return SSM.apply_ssm_decode(p, h, cfg, cache)
    y, (conv, hs) = SSM.apply_ssm(p, h, cfg, return_state=True,
                                  initial_state=cache)
    cache[0].copy_(conv)
    cache[1].copy_(hs)
    return y


class _Par:
    """How one sharded forward lays out its work, from the rules in force:
    ``tp`` — the model axis cuts the layers (``g``, the model group);
    ``seq`` — the residual is cut along the sequence over it (Megatron-SP:
    ``rules.seq``, when the length divides, as the JAX package's
    ``shard_batch`` asks). A region that each model rank computes a part of
    is entered by ``enter`` and left by ``leave``; one that every rank
    computes whole by ``whole`` and ``unwhole``. ``f32_sums`` (serving's)
    adds the ranks' parts in float32 and rounds once: an all-reduce in
    bf16 rounds at every step of its sum, which over 8 ranks moved
    jamba-smoke's bf16 logits past the LM tolerance against the JAX
    package; the trainer's parts are summed in the activation dtype."""

    def __init__(self, rules, S: int, seq: bool = True,
                 f32_sums: bool = False):
        self.rules, self.mesh = rules, rules.mesh
        self.f32_sums = f32_sums
        self.tp = rules.tp is not None
        self.g = self.mesh.model_group if self.tp else None
        m = self.mesh.shape["model"] if self.tp else 1
        self.seq = (seq and self.tp and rules.seq is not None
                    and S % m == 0 and S > 1)

    def enter(self, h):
        if self.seq:
            return comm.all_gather(h, self.g, 1)
        return comm.copy_to(h, self.g)

    def leave(self, y):
        if self.seq:
            return comm.reduce_scatter(y, self.g, 1)
        if self.f32_sums:
            return comm.psum(y.float(), self.g).to(y.dtype)
        return comm.psum(y, self.g)

    def norm(self, p):
        """A norm's weights as this rank applies them: under ``seq`` its
        positions give a part of their gradient, so they enter by
        ``copy_to``."""
        if not self.seq:
            return p
        return {k: comm.copy_to(v, self.g) for k, v in p.items()}

    def whole(self, h):
        return comm.gather_whole(h, self.g, 1) if self.seq else h

    def unwhole(self, y):
        return comm.scatter(y, self.g, 1) if self.seq else y


def _attention_view(p, cfg: ArchConfig, par: _Par) -> dict:
    """The weights this rank's heads read: its blocks of wq and wo, its
    block of wk/wv when the KV heads are cut, else the KV heads its q
    heads use, taken from the whole wk/wv after ``copy_to`` (each rank's
    gradient of them is a part)."""
    if par.rules.kv_heads:
        return p
    sel = torch.tensor(_kv_select(cfg, par, p["wq"].shape[1]),
                       device=p["wk"].device)
    return {"wq": p["wq"], "wo": p["wo"],
            "wk": comm.copy_to(p["wk"], par.g).index_select(1, sel),
            "wv": comm.copy_to(p["wv"], par.g).index_select(1, sel)}


def _sharded_attention(p, h, cfg: ArchConfig, rope, par: _Par, *,
                       causal=True, enc_out=None, train=False):
    """Attention (cross-attention with ``enc_out``) under ``par``: the
    rank's heads when ``rules.heads`` cuts them (column-parallel q/k/v,
    row-parallel wo), else whole on every rank."""
    if not par.tp or not par.rules.heads:
        ckv = None if enc_out is None else L.cross_kv(p, enc_out)
        if not par.tp:
            return L.apply_attention(p, h, rope, causal=causal,
                                     cross_kv=ckv, train=train)
        return par.unwhole(L.apply_attention(
            p, par.whole(h), rope, causal=causal, cross_kv=ckv, train=train))
    view = _attention_view(p, cfg, par)
    ckv = (None if enc_out is None
           else L.cross_kv(view, comm.copy_to(enc_out, par.g)))
    return par.leave(L.apply_attention(view, par.enter(h), rope,
                                       causal=causal, cross_kv=ckv,
                                       train=train))


class _SSMView:
    """An SSD layer's weights as this rank reads them: its heads' blocks,
    w_B/w_C whole and the conv cut to its channels of x plus B and C (all
    after ``copy_to``: each rank's gradient of them is a part)."""

    def __init__(self, p, cfg: ArchConfig, par: _Par):
        d_inner, H, _ = SSM.dims(cfg)
        m = par.mesh.shape["model"]
        if H % m:
            raise ValueError(f"{cfg.name}: {H} SSD heads over a model axis "
                             f"of {m}")
        lo, hi = block_range(d_inner, m, par.mesh.axis_index("model"))
        n_bc = 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        ch = torch.cat([torch.arange(lo, hi), d_inner + torch.arange(n_bc)]
                       ).to(p.conv_w.device)
        self.ch = ch                 # the conv channels this rank reads
        for k in ("w_z", "w_x", "w_dt", "dt_bias", "A_log", "D", "w_out"):
            setattr(self, k, getattr(p, k))
        self.w_B = comm.copy_to(p.w_B, par.g)
        self.w_C = comm.copy_to(p.w_C, par.g)
        self.conv_w = comm.copy_to(p.conv_w, par.g).index_select(1, ch)
        self.conv_b = comm.copy_to(p.conv_b, par.g).index_select(0, ch)


def _sharded_moe(p, h, cfg: ArchConfig, par: _Par):
    """An MoE layer under ``par``: the form the rules pick, as the JAX
    package's ``_apply_sublayer`` picks it; the EP and expert-TP forms take
    the tokens whole over the model group."""
    r = par.rules
    if r.experts and r.moe_impl == "all_to_all":
        return MOE.apply_moe_a2a(p, h, cfg.moe, cfg.activation)
    if r.experts and r.moe_impl == "shard_map":
        y, aux = MOE.apply_moe_shardmap(p, par.whole(h), cfg.moe,
                                        cfg.activation,
                                        f32_sum=par.f32_sums)
    else:
        y, aux = MOE.apply_moe(p, par.whole(h), cfg.moe, cfg.activation,
                               f32_sum=par.f32_sums)
    return par.unwhole(y), aux


def _sharded_sublayer(layer: DecoderLayer, x, cfg: ArchConfig, rope,
                      par: _Par, *, enc_out=None, train=False):
    """``_apply_sublayer`` for training under ``par`` (no cache)."""
    h = L.apply_norm(par.norm(layer.norm1), x, cfg.norm)
    if layer.attn is not None:
        x = x + _sharded_attention(layer.attn, h, cfg, rope, par,
                                   train=train)
        if enc_out is not None and layer.cross is not None:
            hx = L.apply_norm(par.norm(layer.norm_x), x, cfg.norm)
            x = x + _sharded_attention(layer.cross, hx, cfg, None, par,
                                       enc_out=enc_out, train=train)
    elif par.tp:
        x = x + par.leave(SSM.apply_ssm(_SSMView(layer.ssm, cfg, par),
                                        par.enter(h), cfg))
    else:
        x = x + SSM.apply_ssm(layer.ssm, h, cfg)
    aux = None
    if layer.moe is not None or layer.mlp is not None:
        h = L.apply_norm(par.norm(layer.norm2), x, cfg.norm)
        if layer.moe is not None:
            y, aux = _sharded_moe(layer.moe, h, cfg, par)
        elif par.tp:
            y = par.leave(L.apply_mlp(layer.mlp, par.enter(h),
                                      cfg.activation))
        else:
            y = L.apply_mlp(layer.mlp, h, cfg.activation)
        x = x + y
    return x, aux


def _vocab_embed(model: LM, tokens, par: _Par):
    """This rank's part of the embedding: the rows of the tokens in its
    vocabulary block, zeros elsewhere (vocab-parallel)."""
    tok = model.embed["tok"]
    lo, hi = dim_range(par.mesh, par.rules.tp, model.cfg.vocab_padded)
    ids = tokens - lo
    own = (ids >= 0) & (ids < hi - lo)
    rows = tok[ids.clamp(0, max(hi - lo - 1, 0))]
    return torch.where(own[..., None], rows, rows.new_zeros(()))


def _head(model: LM, x, par: _Par | None = None):
    """Final norm and LM head → logits; under ``par`` with TP, this rank's
    vocabulary block of them (column-parallel)."""
    if par is not None and par.tp:
        x = par.enter(L.apply_norm(par.norm(model.final_norm), x,
                                   model.cfg.norm))
    else:
        x = L.apply_norm(model.final_norm, x, model.cfg.norm)
    return L.apply_lm_head(model.embed, model.lm_head, x,
                           model.cfg.tie_embeddings)


def _encode(model: LM, frames, train: bool = False, par=None):
    """The encoder stack of an encoder-decoder model → enc_out [B, S_enc,
    D]: the frames [B, S_enc, D] cast to the activation dtype, each
    encoder layer's non-causal self-attention (RoPE at positions 0 …
    S_enc − 1) and MLP, then ``enc_norm``. The JAX package's KV chunking
    above 4096 frames has no counterpart: the flash kernel streams any
    length. ``train`` sends attention through ``layers.train_attention``;
    the encoder is never rematerialised, as in the JAX package. Under
    ``par`` its layers run sharded, the residual whole along the
    sequence."""
    cfg = model.cfg
    x = frames.to(model.device, model.dtype)
    rope = L.rope_for(torch.arange(x.shape[1], device=model.device), cfg)
    if par is not None:
        par = _Par(par.rules, x.shape[1], seq=False, f32_sums=par.f32_sums)
        for layer in model.encoder:
            h = L.apply_norm(layer.norm1, x, cfg.norm)
            x = x + _sharded_attention(layer.attn, h, cfg, rope, par,
                                       causal=False, train=train)
            h = L.apply_norm(layer.norm2, x, cfg.norm)
            x = x + (par.leave(L.apply_mlp(layer.mlp, par.enter(h),
                                           cfg.activation)) if par.tp
                     else L.apply_mlp(layer.mlp, h, cfg.activation))
        return L.apply_norm(model.enc_norm, x, cfg.norm)
    for layer in model.encoder:
        h = L.apply_norm(layer.norm1, x, cfg.norm)
        x = x + L.apply_attention(layer.attn, h, rope, causal=False,
                                  train=train)
        h = L.apply_norm(layer.norm2, x, cfg.norm)
        x = x + L.apply_mlp(layer.mlp, h, cfg.activation)
    return L.apply_norm(model.enc_norm, x, cfg.norm)


def _embed(model: LM, batch: dict, train: bool = False, par=None):
    """(The embedded tokens [B, S, D] — a VLM's first n positions replaced
    by ``batch["patches"]`` [B, n, D] in the activation dtype, where the
    batch has them — and the encoder output, or None for a model without
    an encoder.) Under ``par`` with TP the lookup is vocab-parallel, summed
    over the model group (cut along the sequence with ``par.seq``)."""
    cfg = model.cfg
    tokens = batch["tokens"].to(model.device)
    patches = (batch["patches"].to(model.device, model.dtype)
               if cfg.modality == "vlm" and "patches" in batch else None)
    if par is not None and par.tp:
        x = _vocab_embed(model, tokens, par)
        if patches is None:
            x = par.leave(x)
        else:
            x = comm.psum(x, par.g)
            x = par.unwhole(torch.cat([patches, x[:, patches.shape[1]:]],
                                      dim=1))
    else:
        x = L.apply_embedding(model.embed, tokens)
        if patches is not None:
            x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
    enc_out = (_encode(model, batch["frames"], train, par) if cfg.enc_layers
               else None)
    return x, enc_out


REMAT = ("none", "full", "dots")


def _save_dots(ctx, op, *args, **kwargs):
    """The ``dots`` policy: keep the weight products (``x @ W`` dispatches
    as ``aten.mm``, or ``addmm``), recompute everything else, batched
    products (``bmm``: attention's, the MoE experts') included — the JAX
    package's ``dots_with_no_batch_dims_saveable``."""
    if op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default):
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat_groups(model: LM) -> tuple:
    """(the prefix layers, the groups): DeepSeekMoE's dense layer 0 stands
    alone, as in the JAX package, then one group a period of
    ``cfg.layer_pattern()`` — the unit its scan body rematerialises."""
    cfg, layers = model.cfg, list(model.layers)
    n_pre = 1 if cfg.moe is not None and cfg.moe.first_dense_ff else 0
    per = len(cfg.layer_pattern())
    return layers[:n_pre], [layers[g:g + per]
                            for g in range(n_pre, len(layers), per)]


def forward(model: LM, batch: dict, *, remat: str = "none",
            train: bool = False):
    """Training/prefill forward → (logits [B, S, vocab_padded], aux loss:
    the float32 sum of the MoE layers' load-balancing losses, 0 for a dense
    model, summed group by group as the JAX package's scan sums it).
    batch: tokens int [B, S]; a VLM's patches [B, n, D] (optional); an
    encoder-decoder model's frames [B, S_enc, D] (the tokens are then the
    decoder's).

    ``train`` sends attention through ``layers.train_attention`` (SDPA on
    the card, the plain version on the CPU; both differentiate), where the
    serving flash kernel, which has no backward, refuses inputs that need
    a gradient. ``remat`` rematerialises each group of ``_remat_groups``
    in the backward pass: ``"none"``; ``"full"`` saves only the group's
    input (``torch.utils.checkpoint``); ``"dots"`` saves the weight
    products as well (``_save_dots``). The forward's values are the same
    in all three."""
    if remat not in REMAT:
        raise ValueError(f"remat {remat!r}, expected one of {REMAT}")
    cfg = model.cfg
    S = batch["tokens"].shape[1]
    r = current_rules()
    par = _Par(r, S) if active(r) else None
    x, enc_out = _embed(model, batch, train, par)
    rope = L.rope_for(torch.arange(S, device=model.device), cfg)

    def run(layers, x):
        aux_g = torch.zeros((), device=model.device)
        for layer in layers:
            x, aux = _apply_sublayer(layer, x, cfg, rope, enc_out=enc_out,
                                     train=train, par=par)
            if aux is not None:
                aux_g = aux_g + aux
        return x, aux_g

    prefix, groups = _remat_groups(model)
    x, aux_total = run(prefix, x)
    for group in groups:
        if remat == "none":
            x, aux_g = run(group, x)
        else:
            ctx = (functools.partial(create_selective_checkpoint_contexts,
                                     _save_dots)
                   if remat == "dots" else noop_context_fn)
            x, aux_g = checkpoint(run, group, x, use_reentrant=False,
                                  context_fn=ctx)
        aux_total = aux_total + aux_g
    return _head(model, x, par), aux_total


def loss_fn(model: LM, batch: dict, *, remat: str = "none",
            aux_weight: float = 0.01):
    """Mean next-token cross-entropy over the labels ≥ 0 (batch["labels"]
    int [B, S]; a negative label is masked), plus ``aux_weight`` × the MoE
    aux loss → (loss, {"ce", "aux"}), float32 0-d tensors. The forward
    takes the training route (``forward(train=True)``). As in the JAX
    package: the logits cast to float32, a logsumexp over the padded
    vocabulary, the gold logit subtracted; here the gold logit is a
    ``gather`` at ``labels.clamp_min(0)``, which equals JAX's sum against
    a float32 one-hot (one nonzero term) without building the [B, S, V]
    one-hot."""
    logits, aux = forward(model, batch, remat=remat, train=True)
    labels = batch["labels"].to(model.device).long()
    lf = logits.float()
    r = current_rules()
    if active(r):
        return _sharded_loss(model, r, lf, labels, aux, aux_weight)
    lse = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    ce = ((lse - gold) * mask).sum() / mask.sum().clamp_min(1.0)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


def _sharded_loss(model: LM, r, lf, labels, aux, aux_weight: float):
    """``loss_fn`` on this rank's rows under the rules ``r``: with TP the
    logits are this rank's vocabulary block, so the logsumexp's max and
    sum are reduced over the model group and the gold logit comes from the
    rank that owns the label; the masked sum and the count are summed over
    the batch axes and the aux loss averaged over them — the global loss,
    on every rank."""
    mesh = r.mesh
    if r.tp:
        g = mesh.model_group
        lo, hi = dim_range(mesh, r.tp, model.cfg.vocab_padded)
        mx = comm.pmax(lf.amax(-1), g)
        lse = mx + comm.psum(torch.exp(lf - mx[..., None]).sum(-1), g).log()
        ids = labels - lo
        own = (ids >= 0) & (ids < hi - lo)
        gold = lf.gather(-1, ids.clamp(0, max(hi - lo - 1, 0))[..., None])
        gold = comm.psum(torch.where(own, gold[..., 0], 0.0), g)
    else:
        lse = torch.logsumexp(lf, dim=-1)
        gold = lf.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    bg = mesh.group(tuple(a for a in r.batch if a in mesh.axis_names))
    ce = (comm.psum(((lse - gold) * mask).sum(), bg)
          / comm.psum(mask.sum(), bg).clamp_min(1.0))
    aux = comm.pmean(aux, bg)
    return ce + aux_weight * aux, {"ce": ce, "aux": aux}


# -- serving --------------------------------------------------------------------

def init_decode_state(model: LM, batch: int, cache_len: int) -> list:
    """One zeroed state pair a layer, in the model's activation dtype: the
    (k, v) caches [batch, cache_len, KV, hd] of an attention layer, the
    (conv, h) state of an SSD layer. Under a mesh each tensor is this
    rank's block of it, cut by ``sharding.decode_state_specs``: the batch
    rows over the batch axes where they divide (``_batch_spec``), a cache
    over its KV heads (``rules.kv_heads``) or along its sequence
    (``rules.kv_seq``: flash-decoding), an SSD layer's conv channels and
    heads over "model" where they divide it."""
    cfg = model.cfg
    r = current_rules()
    if not active(r):
        shape = (batch, cache_len, cfg.n_kv_heads, cfg.hd)
        return [tuple(torch.zeros(shape, dtype=model.dtype,
                                  device=model.device) for _ in range(2))
                if layer.kind == "attn"
                else SSM.init_ssm_state(cfg, batch, model.dtype, model.device)
                for layer in model.layers]
    state = []
    for layer, specs in zip(model.layers, decode_state_specs(cfg, r, batch)):
        if layer.kind == "attn":
            fulls = [(batch, cache_len, cfg.n_kv_heads, cfg.hd)] * 2
        else:
            _, H, ch = SSM.dims(cfg)
            s = cfg.ssm
            fulls = [(batch, s.conv_width - 1, ch),
                     (batch, H, s.d_state, s.head_dim)]
        state.append(tuple(
            torch.zeros(block_shape(f, spec, r.mesh), dtype=model.dtype,
                        device=model.device)
            for f, spec in zip(fulls, specs)))
    return state


@torch.no_grad()
def prefill(model: LM, batch: dict, cache_len: int, *, chunks: int = 1):
    """Run the prompt, return (last-token logits [B, 1, vocab_padded],
    decode state, next_pos). ``chunks > 1`` runs the prompt in sequential
    super-chunks against the growing KV caches and the SSD state carried
    from chunk to chunk (chunked prefill). A VLM's patches replace the
    first positions of the whole prompt before it is cut into chunks; an
    encoder-decoder model encodes its frames once and every chunk attends
    over that output. Under a mesh (``_Serve``) every rank is handed the
    whole batch and takes its rows, the state is this rank's blocks
    (``init_decode_state``) and the logits are gathered whole on every
    rank, as the JAX package's global array."""
    cfg = model.cfg
    B, S = batch["tokens"].shape
    assert S % chunks == 0
    Sc = S // chunks
    state = init_decode_state(model, B, cache_len)
    srv = _Serve.of(model, B)
    if srv is not None:
        batch = {k: srv.rows(v.to(model.device)) for k, v in batch.items()}
    x_full, enc_out = _embed(model, batch, par=srv and srv.par)
    for c in range(chunks):
        x = x_full[:, c * Sc:(c + 1) * Sc]
        rope = L.rope_for(torch.arange(c * Sc, (c + 1) * Sc,
                                       device=model.device), cfg)
        for layer, cache in zip(model.layers, state):
            x, _ = _apply_sublayer(layer, x, cfg, rope, cache=cache,
                                   cache_pos=c * Sc, enc_out=enc_out,
                                   srv=srv)
    if srv is None:
        return _head(model, x[:, -1:]), state, S
    return srv.logits(_head(model, x[:, -1:], srv.par)), state, S


@torch.no_grad()
def decode_step(model: LM, token, state: list, pos, *, enc_out=None):
    """One decode step. token int [B, 1] at position ``pos`` (an int32 0-d
    tensor on the model's device; an int is moved there) → (logits
    [B, 1, vocab_padded], state); the state is written in place. An
    encoder-decoder model takes ``enc_out``, its prompt's ``_encode``
    output (``encode``), as the JAX package's ``decode_step`` does. Under
    a mesh the token and ``enc_out`` are whole, each rank takes its rows,
    and the logits are gathered whole; nothing is read on the host."""
    cfg = model.cfg
    pos = torch.as_tensor(pos, dtype=torch.int32).to(model.device)
    srv = _Serve.of(model, token.shape[0])
    token = token.to(model.device)
    if srv is None:
        x = L.apply_embedding(model.embed, token)
    else:
        token = srv.rows(token)
        enc_out = None if enc_out is None else srv.rows(enc_out)
        x = (srv.par.leave(_vocab_embed(model, token, srv.par))
             if srv.par.tp else L.apply_embedding(model.embed, token))
    rope = L.rope_for(pos.reshape(1), cfg)
    for layer, cache in zip(model.layers, state):
        x, _ = _apply_sublayer(layer, x, cfg, rope, cache=cache,
                               cache_pos=pos, enc_out=enc_out, srv=srv)
    if srv is None:
        return _head(model, x), state
    return srv.logits(_head(model, x, srv.par)), state


@torch.no_grad()
def encode(model: LM, frames):
    """An encoder-decoder model's encoder output [B, S_enc, D] of frames
    [B, S_enc, D] (``_encode``), for ``decode_step(enc_out=)``; under a
    mesh the sharded encoder on this rank's rows, gathered whole."""
    srv = _Serve.of(model, frames.shape[0])
    if srv is None:
        return _encode(model, frames)
    out = _encode(model, srv.rows(frames.to(model.device)), par=srv.par)
    return srv.whole_rows(out)


def block_shape(full: tuple, spec, mesh) -> tuple:
    """The block of a tensor of shape ``full`` that every rank holds under
    ``spec``: ⌈n / size⌉ rows of each cut dimension, as ``NamedSharding``
    pads its shards. Only a cache cut along its sequence can be uneven
    (the other cuts of ``decode_state_specs`` divide): its last ranks then
    hold rows past its length, never written and masked."""
    out = list(full)
    for d, entry in enumerate(spec):
        if spec_axes(entry):
            out[d] = -(-full[d] // mesh.axis_size(spec_axes(entry)))
    return tuple(out)


class _Serve:
    """How ``prefill`` and ``decode_step`` run under the rules in force:
    the batch rows this rank takes (``_batch_spec``: all of them where B
    does not divide the batch axes), the layers' ``_Par`` (no sequence
    cut: the residual is whole along the sequence at serving) and the
    decode state's specs."""

    def __init__(self, model: LM, rules, B: int):
        self.rules, self.mesh, self.B = rules, rules.mesh, B
        self.bs = _batch_spec(rules, B)
        self.par = _Par(rules, 1, seq=False, f32_sums=True)
        self.cfg = model.cfg

    @staticmethod
    def of(model: LM, B: int):
        r = current_rules()
        return _Serve(model, r, B) if active(r) else None

    def rows(self, x):
        """This rank's rows of a whole-batch tensor."""
        if self.bs is None:
            return x
        lo, hi = dim_range(self.mesh, self.bs, x.shape[0])
        return x[lo:hi]

    def whole_rows(self, x):
        """The whole batch of this rank's rows, on every rank."""
        if self.bs is None:
            return x
        return gather_leaf(x, (self.bs,), self.mesh,
                           (self.B, *x.shape[1:]))

    def logits(self, y):
        """The LM head's [B_loc, 1, V_loc] → [B, 1, vocab_padded], on every
        rank: the vocabulary blocks over ``rules.tp``, the rows over the
        batch axes."""
        V = self.cfg.vocab_padded
        spec = (self.bs, None, self.rules.tp if self.par.tp else None)
        return gather_leaf(y, spec, self.mesh, (self.B, 1, V))


def _serve_sublayer(layer: DecoderLayer, x, cfg: ArchConfig, rope,
                    srv: _Serve, cache, cache_pos, enc_out=None):
    """``_apply_sublayer`` with a state under a mesh: the attention on this
    rank's block of the cache (``_serve_attention``), cross-attention with
    its heads cut as the trainer cuts them, an SSD layer on this rank's
    heads and state blocks (``_serve_ssm``), the MLP and MoE layers as the
    sharded forward runs them."""
    par = srv.par
    h = L.apply_norm(layer.norm1, x, cfg.norm)
    if layer.attn is not None:
        x = x + _serve_attention(layer.attn, h, cfg, rope, srv, cache,
                                 cache_pos)
        if enc_out is not None and layer.cross is not None:
            hx = L.apply_norm(layer.norm_x, x, cfg.norm)
            x = x + _sharded_attention(layer.cross, hx, cfg, None, par,
                                       enc_out=enc_out)
    else:
        x = x + _serve_ssm(layer.ssm, h, cfg, srv, cache)
    if layer.moe is not None:
        y, _ = _sharded_moe(layer.moe, L.apply_norm(layer.norm2, x,
                                                    cfg.norm), cfg, par)
        x = x + y
    elif layer.mlp is not None:
        h = L.apply_norm(layer.norm2, x, cfg.norm)
        x = x + (par.leave(L.apply_mlp(layer.mlp, par.enter(h),
                                       cfg.activation)) if par.tp
                 else L.apply_mlp(layer.mlp, h, cfg.activation))
    return x, None


def _serve_ssm(p, h, cfg: ArchConfig, srv: _Serve, cache):
    """An SSD layer with its state under a mesh. With a model axis the
    rank runs its heads (``_SSMView``) on its block of h, and its conv
    window — its channels of x, then B and C — is taken from the conv
    state's layout (``decode_state_specs``: the channels cut evenly over
    "model", or whole) and put back into it after the step, by gathering
    the ranks' x channels."""
    par = srv.par
    if not par.tp:
        return _ssm_with_state(p, h, cfg, cache)
    view = _SSMView(p, cfg, par)
    conv, hs = cache
    cut = conv.shape[2] != SSM.dims(cfg)[2]
    whole = comm.gather_whole(conv, par.g, 2) if cut else conv
    window = whole.index_select(2, view.ch)
    y = _ssm_with_state(view, par.enter(h), cfg, (window, hs))
    d_loc = view.w_x.shape[1]
    whole = torch.cat([comm.gather_whole(window[..., :d_loc].contiguous(),
                                         par.g, 2), window[..., d_loc:]],
                      dim=2)
    if cut:
        lo = par.mesh.axis_index("model") * conv.shape[2]
        whole = whole[..., lo:lo + conv.shape[2]]
    conv.copy_(whole)
    return par.leave(y)


def _kv_select(cfg: ArchConfig, par: _Par, H_loc: int):
    """The KV heads this rank's ``H_loc`` query heads read (as
    ``_attention_view`` picks them from wk/wv): an index into the KV-head
    dimension that keeps the kernel's grouping."""
    G = cfg.n_heads // cfg.n_kv_heads
    h0 = par.mesh.axis_index("model") * H_loc
    kv_of = [(h0 + j) // G for j in range(H_loc)]
    used = sorted(set(kv_of))
    rep = H_loc // len(used)
    grouped = kv_of == [used[j // rep] for j in range(H_loc)]
    return used if grouped else kv_of


def _serve_attention(p, h, cfg: ArchConfig, rope, srv: _Serve, cache,
                     cache_pos):
    """Self-attention over this rank's block of the cache.

    * No model axis (``rules.tp`` None): the one-device attention.
    * ``rules.kv_heads``: the rank's query heads and its block of the KV
      heads (and of the cache): ``layers.apply_attention``, then the
      row-parallel wo summed over the model group.
    * Otherwise the cache is cut along its sequence over ``rules.kv_seq``
      and every rank computes all KV heads' new keys and values (wk/wv are
      whole). At decode (``cache_pos`` a device scalar) only the rank whose
      block holds ``pos`` writes its row — an ``index_copy_`` at the
      clamped local position of the row or of what was there, chosen on
      the device — then each rank attends with all query heads (gathered
      when ``rules.heads`` cuts them) over its block with its local
      ``kv_len`` (0 for a block past the filled rows) and the ranks merge
      by ``comm.merge_partials``. At prefill (``cache_pos`` an int) each
      rank writes its rows of the chunk, and the chunk attends over the
      blocks gathered whole along the sequence (the prefix ``[:kv_len]``),
      with the rank's query heads and the KV heads they read. The cache
      keeps this one layout (``decode_state_specs``'s) at prefill and
      decode alike, where the JAX package cuts a prefill cache's sequence
      only past 8 GiB."""
    par, r = srv.par, srv.rules
    if not par.tp:
        return L.apply_attention(p, h, rope, cache=cache,
                                 cache_pos=cache_pos)
    if r.kv_heads:
        return par.leave(L.apply_attention(p, par.enter(h), rope,
                                           cache=cache, cache_pos=cache_pos))
    hin = par.enter(h)
    q = L.apply_rope(L._proj(hin, p["wq"]), *rope)
    k_new = L.apply_rope(L._proj(hin, p["wk"]), *rope)
    v_new = L._proj(hin, p["wv"])
    ck, cv = cache
    n = ck.shape[1]                       # every rank's block: ⌈len / size⌉
    seq = spec_axes(r.kv_seq)
    lo = srv.mesh.index(seq) * n
    H_loc = p["wq"].shape[1]
    heads_cut = r.heads is not None
    if isinstance(cache_pos, torch.Tensor):
        x_len = h.shape[1]
        at = (cache_pos - lo).clamp(0, n - 1).reshape(1).long()
        own = (cache_pos >= lo) & (cache_pos < lo + n)
        ck.index_copy_(1, at, torch.where(own, k_new, ck.index_select(1, at)))
        cv.index_copy_(1, at, torch.where(own, v_new, cv.index_select(1, at)))
        kv_len = (cache_pos + x_len - lo).clamp(0, n).to(torch.int32)
        if heads_cut:
            q = comm.gather_whole(q, par.g, 2).contiguous()
        out, lse = flash_attention(q, ck, cv, causal=True, kv_len=kv_len,
                                   return_lse=True)
        out = comm.merge_partials(out, lse, par.g)
        if heads_cut:
            h0 = par.mesh.axis_index("model") * H_loc
            out = out[:, :, h0:h0 + H_loc]
    else:
        kv_len = cache_pos + h.shape[1]
        a, b = max(cache_pos, lo), min(kv_len, lo + n)
        if a < b:
            ck[:, a - lo:b - lo] = k_new[:, a - cache_pos:b - cache_pos]
            cv[:, a - lo:b - lo] = v_new[:, a - cache_pos:b - cache_pos]
        g = srv.mesh.group(seq)
        kf = comm.gather_whole(ck, g, 1)[:, :kv_len].contiguous()
        vf = comm.gather_whole(cv, g, 1)[:, :kv_len].contiguous()
        if heads_cut:
            sel = torch.tensor(_kv_select(cfg, par, H_loc), device=kf.device)
            kf, vf = kf.index_select(2, sel), vf.index_select(2, sel)
        out = flash_attention(q, kf, vf, causal=True)
    wo = p["wo"]
    y = out.reshape(*out.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])
    return par.leave(y) if heads_cut else y


class DecodeGraph:
    """Greedy decoding for one (model, batch, cache_len, enc_len): each
    ``step()`` runs ``decode_step`` on static buffers — ``token`` int64
    [B, 1], ``pos`` int32 0-d, ``state`` (the layers' state pairs, each
    written in place by ``copy_``) and, for an encoder-decoder model,
    ``enc_out`` [B, enc_len, D] (None otherwise), from which every step
    computes the cross-attention's keys and values — then writes the greedy
    token into ``token`` and adds one to ``pos``, all on the device. On the
    card the first step runs eagerly and captures the step as a CUDA graph
    (``utils.cuda_graph.StepGraph``); later steps replay it. On the CPU each
    step runs eagerly on the same buffers. ``logits`` is the static buffer
    of the last step's logits [B, 1, vocab_padded]. Under a mesh it
    raises: sharded decode runs ``decode_step`` eagerly."""

    def __init__(self, model: LM, batch: int, cache_len: int,
                 enc_len: int = 0):
        dev, cfg = model.device, model.cfg
        if active(current_rules()):
            raise NotImplementedError(
                "DecodeGraph under a mesh: capturing NCCL collectives in a "
                "CUDA graph is untried; run decode_step eagerly")
        if bool(cfg.enc_layers) != bool(enc_len):
            raise ValueError(f"{cfg.name}: enc_len {enc_len} for a model "
                             f"with {cfg.enc_layers} encoder layers")
        self.model = model
        self.token = torch.zeros((batch, 1), dtype=torch.int64, device=dev)
        self.pos = torch.zeros((), dtype=torch.int32, device=dev)
        self.state = init_decode_state(model, batch, cache_len)
        self.enc_out = (torch.zeros((batch, enc_len, cfg.d_model),
                                    dtype=model.dtype, device=dev)
                        if enc_len else None)
        self.logits = torch.empty((batch, 1, cfg.vocab_padded),
                                  dtype=model.dtype, device=dev)
        self._step = StepGraph(self._greedy, dev)

    @torch.no_grad()
    def _greedy(self) -> None:
        logits, _ = decode_step(self.model, self.token, self.state, self.pos,
                                enc_out=self.enc_out)
        self.logits.copy_(logits)
        self.token.copy_(logits[:, -1].argmax(-1, keepdim=True))
        self.pos.add_(1)

    def start(self, state: list, token, pos, enc_out=None) -> None:
        """Load a prefill's state, the token to feed next, its position (an
        int or an int32 device scalar) and, for an encoder-decoder model,
        the prompt's encoder output into the static buffers."""
        if (enc_out is None) != (self.enc_out is None):
            raise ValueError("DecodeGraph.start: enc_out is given exactly "
                             "when the model has an encoder")
        for mine, given in zip(self.state, state, strict=True):
            for a, b in zip(mine, given, strict=True):
                a.copy_(b)
        if enc_out is not None:
            self.enc_out.copy_(enc_out)
        self.token.copy_(token)
        self.pos.copy_(torch.as_tensor(pos, dtype=torch.int32))

    def step(self) -> torch.Tensor:
        """One greedy step → the static logits buffer."""
        self._step()
        return self.logits


def compile_decode(model: LM, batch: int, cache_len: int,
                   enc_len: int = 0) -> DecodeGraph:
    """The model's ``DecodeGraph`` for (batch, cache_len, enc_len — the
    encoder output's length, 0 for a model without an encoder), built on
    first use and kept on the model."""
    graphs = model.__dict__.setdefault("_decode_graphs", {})
    key = (batch, cache_len, enc_len)
    if key not in graphs:
        graphs[key] = DecodeGraph(model, batch, cache_len, enc_len)
    return graphs[key]


# -- input specs (the dry run) ---------------------------------------------------

def input_specs(cfg: ArchConfig, cell) -> dict:
    """The JAX package's ``input_specs``: every model input of a shape cell
    as an empty ``meta`` tensor of its shape and dtype (int32 tokens,
    labels, token and 0-d pos; bf16 frames, patches and enc_out): a train
    cell's tokens and labels [B, S] (an encoder-decoder model's decoder
    length S/2, with frames [B, S/2, D]; a VLM's patches [B, VLM_PATCHES,
    D]), a prefill cell's tokens (with the same extras), a decode cell's
    token [B, 1] and pos (an encoder-decoder model's enc_out [B, S/2,
    D])."""
    B, S = cell.global_batch, cell.seq_len
    dec = S // 2 if cfg.enc_layers else S

    def meta(*shape, dtype=torch.int32):
        return torch.empty(shape, dtype=dtype, device="meta")
    act = torch.bfloat16
    if cell.kind == "decode":
        spec = {"token": meta(B, 1), "pos": meta()}
        if cfg.enc_layers:
            spec["enc_out"] = meta(B, S // 2, cfg.d_model, dtype=act)
        return spec
    spec = {"tokens": meta(B, dec)}
    if cell.kind == "train":
        spec["labels"] = meta(B, dec)
    if cfg.enc_layers:
        spec["frames"] = meta(B, S // 2, cfg.d_model, dtype=act)
    if cfg.modality == "vlm":
        spec["patches"] = meta(B, VLM_PATCHES, cfg.d_model, dtype=act)
    return spec
