"""Layout quality metrics from the paper: CRE and NELD (+ stress).

CRE  = average number of edge crossings per edge (Table 1).
NELD = edge-length standard deviation / mean edge length (Table 1).

Host numpy, the same definitions as the JAX package's ``graphs/metrics.py``,
so a layout from either package is scored the same way.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.graph import (PaddedGraph, canonical_edges,
                                      unique_edges, to_csr)


def edge_lengths(pos: np.ndarray, edges: np.ndarray) -> np.ndarray:
    p, q = pos[edges[:, 0]], pos[edges[:, 1]]
    return np.linalg.norm(p - q, axis=1)


def neld(pos: np.ndarray, edges: np.ndarray) -> float:
    """Normalized edge-length standard deviation."""
    ln = edge_lengths(np.asarray(pos), np.asarray(edges))
    mu = float(ln.mean())
    if mu <= 0:
        return 0.0
    return float(ln.std() / mu)


def _cross_block(p1, p2, q1, q2, share) -> int:
    """Proper crossings between segment blocks (p1,p2)[B,2] and (q1,q2)[C,2];
    ``share`` masks pairs sharing an endpoint (+ the diagonal)."""
    def orient(a, b, c):
        # sign of cross product (b-a) x (c-a): [B,C]
        return ((b[:, None, 0] - a[:, None, 0]) * (c[None, :, 1] - a[:, None, 1])
                - (b[:, None, 1] - a[:, None, 1]) * (c[None, :, 0] - a[:, None, 0]))

    d1 = orient(p1, p2, q1)
    d2 = orient(p1, p2, q2)
    d3 = orient(q1, q2, p1).T
    d4 = orient(q1, q2, p2).T
    proper = (d1 * d2 < 0) & (d3 * d4 < 0)
    return int(np.count_nonzero(proper & ~share))


def count_crossings(pos: np.ndarray, edges: np.ndarray, block: int = 1024) -> int:
    """Exact proper-crossing count over the canonical edge list, blocked
    O(m^2). Use for m ≲ 5e4."""
    return _count_crossings_canonical(pos, canonical_edges(edges), block)


def _count_crossings_canonical(pos, edges: np.ndarray, block: int) -> int:
    pos = np.asarray(pos, dtype=np.float32)
    m = edges.shape[0]
    if m < 2:
        return 0
    P1, P2 = pos[edges[:, 0]], pos[edges[:, 1]]
    total = 0
    for i0 in range(0, m, block):
        i1 = min(i0 + block, m)
        for j0 in range(i0, m, block):
            j1 = min(j0 + block, m)
            ei, ej = edges[i0:i1], edges[j0:j1]
            share = ((ei[:, 0, None] == ej[None, :, 0]) |
                     (ei[:, 0, None] == ej[None, :, 1]) |
                     (ei[:, 1, None] == ej[None, :, 0]) |
                     (ei[:, 1, None] == ej[None, :, 1]))
            if i0 == j0:
                # only the strict upper triangle within the diagonal block
                ii = np.arange(i1 - i0)
                share = share | (ii[:, None] >= ii[None, :])
            total += _cross_block(P1[i0:i1], P2[i0:i1], P1[j0:j1], P2[j0:j1],
                                  share)
    return total


def cre(pos: np.ndarray, edges: np.ndarray, block: int = 1024) -> float:
    """Average crossings per edge (each crossing involves 2 edges),
    normalized by the canonical edge count."""
    edges = canonical_edges(edges)
    m = int(edges.shape[0])
    if m == 0:
        return 0.0
    return 2.0 * _count_crossings_canonical(pos, edges, block) / m


def bfs_distances(edges: np.ndarray, n: int, sources: np.ndarray) -> np.ndarray:
    """Host BFS from each source → int32[len(sources), n] (unreachable=-1)."""
    row_ptr, col = to_csr(edges, n)
    out = np.full((len(sources), n), -1, dtype=np.int32)
    for si, s in enumerate(sources):
        dist = out[si]
        dist[s] = 0
        frontier = [int(s)]
        d = 0
        while frontier:
            d += 1
            nxt = []
            for u in frontier:
                for v in col[row_ptr[u]:row_ptr[u + 1]]:
                    if dist[v] < 0:
                        dist[v] = d
                        nxt.append(int(v))
            frontier = nxt
    return out


def sampled_stress(pos: np.ndarray, edges: np.ndarray, n: int,
                   n_sources: int = 16, seed: int = 0) -> float:
    """Normalized stress over BFS distances from sampled sources."""
    rng = np.random.default_rng(seed)
    sources = rng.choice(n, size=min(n_sources, n), replace=False)
    D = bfs_distances(edges, n, sources)
    P = np.asarray(pos)[:n]
    num = den = 0.0
    for si in range(D.shape[0]):
        d = D[si]
        ok = d > 0
        geo = np.linalg.norm(P - P[sources[si]], axis=1)[ok]
        gd = d[ok].astype(np.float64)
        # scale-invariant stress: optimal scalar fit
        alpha = float((geo * gd).sum() / max((geo * geo).sum(), 1e-12))
        num += float((((alpha * geo) - gd) ** 2 / gd ** 2).sum())
        den += float(ok.sum())
    return num / max(den, 1.0)


def quality_report(g: PaddedGraph, pos, max_cre_edges: int = 40000) -> dict:
    """CRE/NELD/stress summary of a layout of ``g`` (host arrays)."""
    edges = unique_edges(g)
    posn = np.asarray(pos)[: g.n_pad]
    rep = {
        "n": g.n, "m": g.m,
        "neld": neld(posn, edges),
        "stress": sampled_stress(posn, edges, g.n),
    }
    rep["cre"] = cre(posn, edges) if g.m <= max_cre_edges else float("nan")
    return rep
