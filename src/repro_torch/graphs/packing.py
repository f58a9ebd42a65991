"""Packing B same-bucket graphs into one batched refine program: the JAX
package's ``graphs/packing.py`` on torch tensors.

The multi-graph driver (``core/multilevel.py:multigila_layout_many``) lays
out many graphs at once by stacking every level that lands in the same
shape bucket into ``[B, n_pad]`` lanes and running ONE cached batched
refine step for the whole group (``core/bucketing.py``). This module holds
the array plumbing that makes that safe:

  * ``repad_graph`` — re-pad a ``PaddedGraph`` to another (n_pad, m_pad),
    rewriting the sentinel indices. Randomness is drawn per vertex and
    padding rows contribute zero, so the same graph padded to 64 or 256
    slots gives the same positions, bit for bit, for every real vertex. The
    batched driver uses this to drop each lane to the finest bucket that
    fits (a floor below the single-graph driver's 256).
  * ``incidence_table`` — the half-edge slots arriving at each vertex, in
    ascending order: gathered and added column by column, they sum each
    vertex's messages in ``segment_sum``'s order, without a scatter.
  * ``pack_graphs`` / ``pad_lanes`` — stack same-shape lanes and pad the
    lane axis to a power-of-two lane bucket, so the number of batched
    programs stays logarithmic in the largest group. Dead lanes replicate
    lane 0 and run with an iteration budget of 0: they ride through the
    loop untouched.

Everything here is a torch tensor on the graph's device.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graphs.graph import PaddedGraph, bucket_pad


def repad_graph(g: PaddedGraph, n_pad: int, m_pad: int) -> PaddedGraph:
    """``g`` re-padded to (n_pad, m_pad), sentinels rewritten to the new
    n_pad. Valid half-edges are compacted to a prefix in their original
    order (``build_graph`` already stores them so: the identity
    permutation), which keeps ``segment_sum``'s accumulation order."""
    if n_pad < g.n or m_pad < 2 * g.m:
        raise ValueError(f"repad_graph: (n_pad, m_pad) = ({n_pad}, {m_pad}) "
                         f"below (n, 2m) = ({g.n}, {2 * g.m})")
    if n_pad == g.n_pad and m_pad == g.m_pad:
        return g
    dev = g.device
    keep = torch.nonzero(g.emask).squeeze(1)           # order-preserving
    k = int(keep.shape[0])
    if k > m_pad:
        raise ValueError(f"repad_graph: {k} valid half-edges, m_pad {m_pad}")
    src = torch.full((m_pad,), n_pad, dtype=torch.int32, device=dev)
    dst = torch.full((m_pad,), n_pad, dtype=torch.int32, device=dev)
    ewt = torch.ones((m_pad,), dtype=torch.float32, device=dev)
    emask = torch.zeros((m_pad,), dtype=torch.bool, device=dev)
    src[:k] = g.src[keep]
    dst[:k] = g.dst[keep]
    ewt[:k] = g.ewt[keep]
    emask[:k] = True
    vmask = torch.zeros((n_pad,), dtype=torch.bool, device=dev)
    vmask[:g.n] = g.vmask[:g.n]
    mass = torch.zeros((n_pad,), dtype=torch.float32, device=dev)
    mass[:g.n] = g.mass[:g.n]
    return PaddedGraph(src=src, dst=dst, vmask=vmask, emask=emask, mass=mass,
                       ewt=ewt, n=g.n, m=g.m)


def repad_rows(a: torch.Tensor, n_pad: int) -> torch.Tensor:
    """Slice or zero-pad the leading (vertex) axis of ``a`` to ``n_pad``
    rows. Rows past the valid count are padding: their values never reach
    a real vertex, so cutting them off or appending zeros changes no real
    vertex's result."""
    if a.shape[0] == n_pad:
        return a
    if a.shape[0] > n_pad:
        return a[:n_pad]
    return torch.cat([a, a.new_zeros((n_pad - a.shape[0],) + a.shape[1:])])


def incidence_table(g: PaddedGraph, k: int = 32):
    """(int32[n_pad, k] on g's device, k): the half-edge slots arriving at
    each vertex, ascending, sentinel slot m_pad; or ``(None, max_degree)``
    when a vertex's degree exceeds ``k``.

    ``k`` is a constant, not a bucket of the observed max degree: it is part
    of the batched cache key (``core/bucketing.py``), and a data-dependent k
    would mint fresh entries on the warm path. Slots are listed in the order
    in which a scatter-add (``segment_sum``) applies them, so an unrolled
    left-associated gather-and-add over the k columns sums each vertex's
    messages in the sequential driver's float order."""
    dst = g.dst.cpu().numpy()
    slots = np.nonzero(g.emask.cpu().numpy())[0]
    d = dst[slots]
    if d.size == 0:
        return torch.full((g.n_pad, k), g.m_pad, dtype=torch.int32,
                          device=g.device), k
    counts = np.bincount(d, minlength=g.n_pad)
    dmax = int(counts.max())
    if dmax > k:
        return None, dmax
    order = np.argsort(d, kind="stable")        # stable: slots stay ascending
    ds, ss = d[order], slots[order]
    rank = np.arange(ds.size) - np.searchsorted(ds, ds, side="left")
    inc = np.full((g.n_pad, k), g.m_pad, np.int32)
    inc[ds, rank] = ss
    return torch.from_numpy(inc).to(g.device), k


@dataclasses.dataclass
class PackedGraphs:
    """B same-shape lanes stacked into one ``PaddedGraph`` of ``[B, n_pad]``
    / ``[B, m_pad]`` tensors (``n``/``m`` 0: the batched step reads shapes
    only; the graph's own ``n_pad``/``m_pad`` properties read the lane axis,
    so use these). ``b`` is the number of REAL lanes: lanes b..B-1 are dead
    padding."""
    g: PaddedGraph
    b: int

    @property
    def lanes(self) -> int:
        return int(self.g.vmask.shape[0])

    @property
    def n_pad(self) -> int:
        return int(self.g.vmask.shape[1])

    @property
    def m_pad(self) -> int:
        return int(self.g.src.shape[1])


def lane_bucket(b: int, minimum: int = 8) -> int:
    """Pow2 lane bucket with a floor: straggler waves (a few hierarchies one
    level deeper than the rest) reuse the floor-size program instead of
    capturing a fresh B = 1/2/4 one."""
    return bucket_pad(b, minimum)


def pad_lanes(stacked: torch.Tensor, b: int, lanes: int) -> torch.Tensor:
    """Pad the lane axis of ``stacked`` ([b, ...]) to ``lanes`` rows by
    replicating lane 0. Dead lanes run with iters = 0, so the copies only
    keep shapes and dtypes honest."""
    if b == lanes:
        return stacked
    return torch.cat([stacked, stacked[0:1].expand((lanes - b,)
                                                   + stacked.shape[1:])])


def pack_graphs(gs: list[PaddedGraph], lanes: int | None = None
                ) -> PackedGraphs:
    """Stack same-shape graphs into lanes, padded to ``lanes`` (default
    ``lane_bucket(len(gs))``)."""
    if not gs:
        raise ValueError("pack_graphs needs at least one lane")
    n_pad, m_pad = gs[0].n_pad, gs[0].m_pad
    if any((g.n_pad, g.m_pad) != (n_pad, m_pad) for g in gs):
        raise ValueError("pack_graphs: all lanes must share one shape bucket")
    lanes = lanes if lanes is not None else lane_bucket(len(gs))
    if lanes < len(gs):
        raise ValueError(f"pack_graphs: {len(gs)} graphs, {lanes} lanes")

    def stack(field):
        return pad_lanes(torch.stack([getattr(g, field) for g in gs]),
                         len(gs), lanes)

    batched = PaddedGraph(src=stack("src"), dst=stack("dst"),
                          vmask=stack("vmask"), emask=stack("emask"),
                          mass=stack("mass"), ewt=stack("ewt"), n=0, m=0)
    return PackedGraphs(g=batched, b=len(gs))
