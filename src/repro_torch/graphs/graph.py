"""Static-shape padded graph representation on torch tensors.

Every graph is stored with BOTH directions of each undirected edge so that a
segment reduction over ``dst`` aggregates all messages arriving at a vertex —
the dense-array equivalent of a Giraph superstep's message delivery.

Padding convention (the JAX package's, unchanged): invalid vertices/edges use
the sentinel index ``n_pad`` (one past the last valid slot). Segment
reductions therefore use ``n_pad + 1`` segments and drop the last row.
Indices are stored as int32; torch's scatter and ``index_add_`` take int64,
so each graph keeps one int64 copy of ``src``/``dst`` made on first use.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from repro_torch.utils.device import resolve_device


PAD_MULT = 256           # padding granularity and pow2-bucket minimum


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def bucket_pad(x: int, minimum: int = PAD_MULT) -> int:
    """Next power-of-two ≥ max(x, minimum, 1) — the shape-bucket padding.
    The schedule keys grid sizes on it, so it must match the JAX package's.
    The single-graph driver keeps the floor ``PAD_MULT``; the batched driver
    pads its lanes with floors of 64 vertices and 512 half-edges
    (``core/bucketing.py:lane_shape``)."""
    x = max(int(x), minimum, 1)
    return 1 << (x - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class PaddedGraph:
    """A padded, undirected graph as tensors on one device.

    Attributes:
      src, dst:   int32[m_pad] — directed half-edges (each undirected edge
                  appears once per direction). Padding rows are (n_pad, n_pad).
      vmask:      bool[n_pad] — valid-vertex mask.
      emask:      bool[m_pad] — valid-half-edge mask.
      mass:       float32[n_pad] — vertex masses (≥1 after pruning).
      ewt:        float32[m_pad] — desired-length weight per half edge.
      n, m:       number of valid vertices / undirected edges.
    """
    src: torch.Tensor
    dst: torch.Tensor
    vmask: torch.Tensor
    emask: torch.Tensor
    mass: torch.Tensor
    ewt: torch.Tensor
    n: int
    m: int

    @property
    def n_pad(self) -> int:
        return int(self.vmask.shape[0])

    @property
    def m_pad(self) -> int:
        return int(self.src.shape[0])

    @property
    def device(self) -> torch.device:
        return self.vmask.device

    @functools.cached_property
    def src_l(self) -> torch.Tensor:
        """int64 copy of ``src`` for torch indexing."""
        return self.src.long()

    @functools.cached_property
    def dst_l(self) -> torch.Tensor:
        """int64 copy of ``dst`` for torch scatter/``index_add_``."""
        return self.dst.long()


def build_graph(edges: np.ndarray, n: int, *, n_pad: int | None = None,
                m_pad: int | None = None, mass: np.ndarray | None = None,
                ewt: np.ndarray | None = None, bucket: bool = False,
                device=None) -> PaddedGraph:
    """Build a PaddedGraph from a unique undirected edge list ``edges[k,2]``
    — the JAX package's ``build_graph``, buffer layout for buffer layout.

    Self loops and duplicate edges must already be removed. ``n_pad``/
    ``m_pad`` default to the sizes rounded up to ``PAD_MULT``; with
    ``bucket=True`` they round up to the next power-of-two bucket.
    """
    dev = resolve_device(device)
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    m = int(edges.shape[0])
    if n_pad is None:
        n_pad = (bucket_pad(n) if bucket
                 else max(_round_up(max(n, 1), PAD_MULT), PAD_MULT))
    if m_pad is None:
        m_pad = (bucket_pad(2 * m) if bucket
                 else max(_round_up(max(2 * m, 1), PAD_MULT), PAD_MULT))
    if m_pad < 2 * m or n_pad < n:
        raise ValueError(f"padding too small: n={n} n_pad={n_pad} "
                         f"m={m} m_pad={m_pad}")

    src = np.full((m_pad,), n_pad, dtype=np.int32)
    dst = np.full((m_pad,), n_pad, dtype=np.int32)
    emask = np.zeros((m_pad,), dtype=bool)
    w = np.ones((m_pad,), dtype=np.float32)
    if m:
        src[: 2 * m] = np.concatenate([edges[:, 0], edges[:, 1]])
        dst[: 2 * m] = np.concatenate([edges[:, 1], edges[:, 0]])
        emask[: 2 * m] = True
        if ewt is not None:
            ew = np.asarray(ewt, dtype=np.float32).reshape(-1)
            w[: 2 * m] = np.concatenate([ew, ew])
    vmask = np.zeros((n_pad,), dtype=bool)
    vmask[:n] = True
    ms = np.zeros((n_pad,), dtype=np.float32)
    ms[:n] = 1.0 if mass is None else np.asarray(mass, dtype=np.float32)[:n]
    t = lambda a: torch.from_numpy(a).to(dev)
    return PaddedGraph(src=t(src), dst=t(dst), vmask=t(vmask),
                       emask=t(emask), mass=t(ms), ewt=t(w), n=n, m=m)


def unique_edges(g: PaddedGraph) -> np.ndarray:
    """The (host) unique undirected edge list [m, 2] (src < dst)."""
    src = g.src[: 2 * g.m].cpu().numpy()
    dst = g.dst[: 2 * g.m].cpu().numpy()
    keep = src < dst
    return np.stack([src[keep], dst[keep]], axis=1).astype(np.int64)


def canonical_edges(edges: np.ndarray) -> np.ndarray:
    """Drop self loops, sort each pair's endpoints, collapse duplicates."""
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    if e.size == 0:
        return e.reshape(0, 2)
    e = np.sort(e, axis=1)
    return np.unique(e, axis=0)


def to_csr(edges: np.ndarray, n: int) -> tuple[np.ndarray, np.ndarray]:
    """Host-side CSR (row_ptr[n+1], col_idx[2m]) from unique undirected edges."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    both = np.concatenate([edges, edges[:, ::-1]], axis=0)
    order = np.argsort(both[:, 0], kind="stable")
    both = both[order]
    col = both[:, 1].astype(np.int32)
    counts = np.bincount(both[:, 0], minlength=n)
    row_ptr = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=row_ptr[1:])
    return row_ptr, col


# -- message-passing primitives (the Giraph superstep vocabulary) -------------

def edge_gather(g: PaddedGraph, values: torch.Tensor) -> torch.Tensor:
    """Per half-edge value read from the SOURCE endpoint (padding → 0-row)."""
    padded = torch.cat([values, values.new_zeros((1,) + values.shape[1:])])
    return padded[g.src_l]


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Sum of ``values`` rows per segment id (int64 ``seg``)."""
    out = values.new_zeros((num_segments,) + values.shape[1:])
    return out.index_add_(0, seg, values)


def segment_max(values: torch.Tensor, seg: torch.Tensor, num_segments: int,
                floor: int) -> torch.Tensor:
    """Max of ``values`` per segment, never below ``floor`` (the value an
    empty segment gets)."""
    out = values.new_full((num_segments,), floor)
    return out.scatter_reduce_(0, seg, values, "amax", include_self=True)


def push_max(g: PaddedGraph, values: torch.Tensor) -> torch.Tensor:
    """Superstep: broadcast int values, combine with max (-1 = no message).
    The sentinel segment ``n_pad`` is dropped."""
    msgs = torch.where(g.emask, edge_gather(g, values), -1)
    return segment_max(msgs, g.dst_l, g.n_pad + 1, -1)[: g.n_pad]
