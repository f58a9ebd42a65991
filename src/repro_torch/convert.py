"""Carry the JAX package's state across to the port.

The layout system's carried state is the graph and the hierarchy; the LM's
is its weights and its optimizer state. Each function takes the JAX
package's arrays as numpy arrays (the caller converts with ``np.asarray``)
and returns the port's structure on ``device`` — so both packages can be
fed identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.solar_merger import LevelInfo, MergerState
from repro_torch.graphs.graph import PaddedGraph
from repro_torch.models.model import LM
from repro_torch.models.moe import MoE
from repro_torch.models.ssm import SSM
from repro_torch.train.optim import OptState
from repro_torch.utils.device import resolve_device


def _t(a, dtype, dev) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=dtype)).to(dev)


def padded_graph(src, dst, vmask, emask, mass, ewt, n: int, m: int, *,
                 device=None) -> PaddedGraph:
    """A ``PaddedGraph`` from the JAX package's ``PaddedGraph`` fields."""
    dev = resolve_device(device)
    return PaddedGraph(src=_t(src, np.int32, dev), dst=_t(dst, np.int32, dev),
                       vmask=_t(vmask, bool, dev), emask=_t(emask, bool, dev),
                       mass=_t(mass, np.float32, dev),
                       ewt=_t(ewt, np.float32, dev), n=int(n), m=int(m))


def merger_state(state, sun, depth, parent, *, device=None) -> MergerState:
    dev = resolve_device(device)
    return MergerState(*(_t(a, np.int32, dev)
                         for a in (state, sun, depth, parent)))


def level_info(parent_coarse, sun_of, depth, state, sun_pos_index, *,
               device=None) -> LevelInfo:
    dev = resolve_device(device)
    return LevelInfo(*(_t(a, np.int32, dev) for a in (
        parent_coarse, sun_of, depth, state, sun_pos_index)))


def neighbor_lists(nbr_idx, nbr_mask, *, device=None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The padded k-hop lists ``(int32[n_pad, K], bool[n_pad, K])``."""
    dev = resolve_device(device)
    return _t(nbr_idx, np.int32, dev), _t(nbr_mask, bool, dev)


def lm_params(params, cfg, *, device=None, dtype=torch.bfloat16) -> LM:
    """An ``LM`` holding the JAX package's ``init_params`` weights.

    ``params`` is that pytree with numpy leaves. Its layer weights are
    stacked ``[G, ...]`` under ``params["groups"]``, one dict a position of
    the layer pattern: layer ``prefix + g·len(pattern) + i`` is entry ``g``
    of ``params["groups"][i]``. DeepSeekMoE's dense layer 0 sits unstacked
    in ``params["prefix"][0]``, and the stacked groups then start at layer
    1. An MoE layer's ``moe`` carries the router (kept float32), the
    experts' weights and, with shared experts, ``moe["shared"]``; an SSD
    layer's ``ssm`` its 11 weights; an encoder-decoder model's attention
    layer its ``norm_x`` and ``cross``. An encoder-decoder model's encoder
    layers are stacked ``[enc_layers, ...]`` under ``params["encoder"]``
    (encoder layer e is entry e), its final encoder norm is
    ``params["enc_norm"]``. Matmul weights are cast once to ``dtype``, as
    JAX casts them at use; norm scales and the SSD's float32 weights stay
    float32 (``lm_leaves`` gives the mapping).
    """
    model = LM(cfg, dtype=dtype, device=device)
    leaves = lm_leaves(params, model)
    for name, p in model.named_parameters():
        p.copy_(torch.from_numpy(np.array(leaves[name], np.float32)))
    return model


def lm_leaves(tree, model: LM) -> dict:
    """{the name of each of ``model``'s parameters: the leaf of ``tree`` at
    its place}, for any pytree shaped like the JAX package's params — the
    params themselves, their gradients, or an optimizer state's mu, nu or
    master (``lm_params`` has the layout)."""
    groups = tree["groups"]
    G = len(groups[0]["norm1"]["scale"])
    per_layer = list(tree.get("prefix", [])) + [
        _take(groups[i], g) for g in range(G) for i in range(len(groups))]
    if len(per_layer) != len(model.layers):
        raise ValueError(f"{len(per_layer)} layers for a model of "
                         f"{len(model.layers)}")
    nested = dict(tree, layers=dict(enumerate(per_layer)))
    if model.encoder is not None:
        nested["encoder"] = {e: _take(tree["encoder"], e)
                             for e in range(len(model.encoder))}
    out = {}
    for name, _ in model.named_parameters():
        node = nested
        for part in name.split("."):
            node = node[int(part) if part.isdigit() else part]
        out[name] = node
    return out


def opt_state(st, model: LM, *, device=None) -> OptState:
    """The port's ``OptState`` of the JAX package's (numpy leaves: ``step``,
    ``mu``, ``nu`` and ``master`` or None, each shaped like the params),
    float32 on ``device``: both packages then step from the same float32
    masters, where the port's own ``init_opt_state`` would start from its
    bf16 weights."""
    dev = resolve_device(device)

    def tree(t):
        return {k: _t(a, np.float32, dev)
                for k, a in lm_leaves(t, model).items()}
    return OptState(step=_t(st.step, np.int32, dev), mu=tree(st.mu),
                    nu=tree(st.nu),
                    master=None if st.master is None else tree(st.master))


def ssm_params(p, cfg, *, device=None, dtype=torch.bfloat16) -> SSM:
    """An ``SSM`` layer holding the JAX package's ``init_ssm`` weights
    ``p`` (numpy leaves; the float32 ones stay float32)."""
    layer = SSM(cfg, dtype, resolve_device(device))
    _put(layer, p)
    return layer


def moe_params(p, m, d_model: int, *, device=None,
               dtype=torch.bfloat16) -> MoE:
    """An ``MoE`` layer holding the JAX package's ``init_moe`` weights
    ``p`` (numpy leaves; the router stays float32)."""
    layer = MoE(d_model, m, dtype, resolve_device(device))
    _put(layer, p)
    return layer


def _put(dst, src: dict) -> None:
    """Copy each parameter of the module ``dst`` from the (nested) dict
    ``src`` of numpy arrays, at the parameter's dotted name, into its
    dtype."""
    for name, p in dst.named_parameters():
        node = src
        for part in name.split("."):
            node = node[part]
        p.copy_(torch.from_numpy(np.array(node, np.float32)))


def _take(tree, i):
    """Entry ``i`` of every leaf of a stacked (nested) dict."""
    if isinstance(tree, dict):
        return {k: _take(v, i) for k, v in tree.items()}
    return tree[i]
