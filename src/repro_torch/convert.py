"""Carry the JAX package's state across to the port.

This system has no weights: its carried state is the graph and the
hierarchy. Each function takes the JAX package's arrays as numpy arrays (the
caller converts with ``np.asarray``) and returns the port's structure on
``device`` — so both packages can be fed identical inputs.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.solar_merger import LevelInfo, MergerState
from repro_torch.graphs.graph import PaddedGraph
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
