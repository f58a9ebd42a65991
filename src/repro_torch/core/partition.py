"""Spinner-style balanced label-propagation partitioning (paper §3.1).

Vaquero et al.'s Spinner assigns vertices to P partitions by iterated label
propagation with a balance penalty; Multi-GiLA uses it so that workers
exchange few cross-partition messages. The labels drive the vertex
reordering that makes each mesh rank own a contiguous, mostly internal
block (fewer remote reads in the halo-exchange superstep of
``core/distributed.py``). The JAX package's ``core/partition.py`` on torch:
the ``iters`` supersteps run as one Python loop over device tensors, with
the coin flips drawn through ``utils/prng.py``, so the labels equal the JAX
package's bit for bit.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.graphs.graph import PaddedGraph, edge_gather, segment_sum
from repro_torch.utils import prng


def _propagate(g: PaddedGraph, labels, loads, key, capacity):
    """One Spinner superstep: each vertex scores every label by neighbor
    frequency minus a load penalty, and adopts the argmax with probability
    1/2, subject to a per-label migration quota: each label admits at most
    ``capacity - load`` movers (ranked by vertex id through a stable sort),
    so a label never grows past its capacity and max load ≤ max(initial
    load, capacity) at every step. The rest stay put and may retry."""
    n_pad, P = g.n_pad, loads.shape[0]
    onehot = torch.nn.functional.one_hot(labels.long(), P).float()
    msgs = torch.where(g.emask[:, None], edge_gather(g, onehot), 0.0)
    freq = segment_sum(msgs, g.dst_l, n_pad + 1)[:n_pad]
    deg = torch.clamp_min(freq.sum(dim=1, keepdim=True), 1.0)
    score = freq / deg - (loads / capacity)[None, :]
    best = torch.argmax(score, dim=1).to(torch.int32)
    flip = prng.bernoulli(key, 0.5, n_pad, device=labels.device)
    wants = flip & g.vmask & (best != labels)
    # rank the movers targeting each label (a stable sort on the target:
    # the rank is the position within the label group, in vertex-id order)
    # and admit only as many as the label has room for
    target = torch.where(wants, best, P)                 # P = "no move"
    ts, order = torch.sort(target, stable=True)
    rank = (torch.arange(n_pad, device=labels.device)
            - torch.searchsorted(ts, ts, side="left"))
    quota = torch.floor(torch.clamp_min(capacity - loads, 0.0))
    ok_sorted = (ts < P) & (rank < quota[torch.clamp(ts, 0, P - 1).long()])
    admitted = torch.zeros(n_pad, dtype=torch.bool, device=labels.device)
    admitted[order] = ok_sorted
    new = torch.where(admitted, best, labels)
    return new, _loads(new, g.vmask, P)


def _loads(labels, vmask, P: int) -> torch.Tensor:
    """float32[P]: valid vertices per label."""
    return torch.bincount(torch.where(vmask, labels, P).long(),
                          minlength=P + 1)[:P].float()


def spinner_partition(g: PaddedGraph, n_parts: int, *, iters: int = 32,
                      slack: float = 1.10, seed: int = 0) -> np.ndarray:
    """int32[n_pad] partition labels on the host (balanced within
    ``slack``): a blocked start, then ``iters`` supersteps, each with its
    own key of ``split(PRNGKey(seed), iters)``."""
    n_pad, dev = g.n_pad, g.device
    base = np.minimum(np.arange(n_pad) * n_parts // max(g.n, 1), n_parts - 1)
    labels = torch.from_numpy(base.astype(np.int32)).to(dev)
    capacity = torch.tensor(np.float32(slack * max(g.n, 1) / n_parts),
                            device=dev)
    loads = _loads(labels, g.vmask, n_parts)
    for key in prng.split(prng.prng_key(seed), iters):
        labels, loads = _propagate(g, labels, loads, key, capacity)
    return labels.cpu().numpy()


def edge_cut(g: PaddedGraph, labels: np.ndarray) -> float:
    """Fraction of (half-)edges crossing partitions."""
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    em = g.emask.cpu().numpy()
    lab = np.concatenate([np.asarray(labels), [-1]])
    cross = lab[src[em]] != lab[dst[em]]
    return float(cross.mean()) if cross.size else 0.0


def partition_order(labels: np.ndarray, vmask) -> np.ndarray:
    """Permutation placing same-partition vertices contiguously (valid
    first)."""
    vmask = np.asarray(vmask.cpu() if isinstance(vmask, torch.Tensor)
                       else vmask)
    key = np.where(vmask, labels, labels.max() + 1)
    return np.argsort(key, kind="stable")
