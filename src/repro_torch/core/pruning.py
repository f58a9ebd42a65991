"""Degree-1 pruning and reinsertion (paper §3.1).

Pruning removes every degree-1 vertex in one pass; its host vertex's mass is
incremented so the coarsening sees the pruned weight. Reinsertion places each
pruned vertex in the widest angular gap around its host at half the host's
mean incident edge length — the paper's "ad-hoc technique avoiding additional
edge crossings" (a leaf placed inside the widest empty sector of its host
cannot cross the host's incident edges near the host).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.graphs.graph import to_csr


@dataclasses.dataclass
class PruneResult:
    edges: np.ndarray       # pruned unique edge list (renumbered)
    n: int                  # vertices after pruning
    mass: np.ndarray        # float32[n] — 1 + #pruned leaves per host
    old_of_new: np.ndarray  # int64[n] — original index per kept vertex
    leaves: np.ndarray      # int64[k] — original indices of pruned leaves
    leaf_host: np.ndarray   # int64[k] — original index of each leaf's host
    n_orig: int
    ewt: np.ndarray | None = None  # float32[len(edges)] — surviving weights


def prune_degree_one(edges: np.ndarray, n: int,
                     weights: np.ndarray | None = None) -> PruneResult:
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if weights is not None:
        weights = np.asarray(weights, np.float32).reshape(-1)
    deg = np.zeros(n, dtype=np.int64)
    np.add.at(deg, edges[:, 0], 1)
    np.add.at(deg, edges[:, 1], 1)
    leaf = deg == 1
    # never prune both endpoints of an isolated K2: keep the smaller index
    both = leaf[edges[:, 0]] & leaf[edges[:, 1]]
    if both.any():
        keep = np.minimum(edges[both, 0], edges[both, 1])
        leaf[keep] = False

    e_leaf = leaf[edges[:, 0]] | leaf[edges[:, 1]]
    leaves_e = edges[e_leaf]
    l_is_0 = leaf[leaves_e[:, 0]]
    leaves = np.where(l_is_0, leaves_e[:, 0], leaves_e[:, 1])
    hosts = np.where(l_is_0, leaves_e[:, 1], leaves_e[:, 0])

    kept = ~leaf
    old_of_new = np.nonzero(kept)[0]
    new_of_old = np.full(n, -1, dtype=np.int64)
    new_of_old[old_of_new] = np.arange(old_of_new.size)
    e2 = edges[~e_leaf]
    e2 = np.stack([new_of_old[e2[:, 0]], new_of_old[e2[:, 1]]], axis=1)
    mass = np.ones(old_of_new.size, dtype=np.float32)
    np.add.at(mass, new_of_old[hosts], 1.0)
    return PruneResult(edges=e2, n=int(old_of_new.size), mass=mass,
                       old_of_new=old_of_new, leaves=leaves, leaf_host=hosts,
                       n_orig=n,
                       ewt=weights[~e_leaf] if weights is not None else None)


def reinsert(pr: PruneResult, pos_kept: np.ndarray,
             pruned_edges: np.ndarray) -> np.ndarray:
    """Return positions for ALL original vertices given the kept layout."""
    pos = np.zeros((pr.n_orig, 2), dtype=np.float32)
    pos[pr.old_of_new] = np.asarray(pos_kept)[: pr.n]
    if pr.leaves.size == 0:
        return pos

    row_ptr, col = to_csr(pruned_edges, pr.n) if pruned_edges.size else (
        np.zeros(pr.n + 1, np.int64), np.zeros(0, np.int32))
    new_of_old = np.full(pr.n_orig, -1, dtype=np.int64)
    new_of_old[pr.old_of_new] = np.arange(pr.n)

    # group leaves per host so multiple leaves fan out inside the gap
    order = np.argsort(pr.leaf_host, kind="stable")
    leaves = pr.leaves[order]
    hosts = pr.leaf_host[order]
    i = 0
    while i < len(leaves):
        j = i
        while j < len(leaves) and hosts[j] == hosts[i]:
            j += 1
        h_old = hosts[i]
        h = new_of_old[h_old]
        ph = pos[h_old]
        nb = col[row_ptr[h]:row_ptr[h + 1]] if h >= 0 else np.zeros(0, np.int64)
        if len(nb):
            vecs = np.asarray(pos_kept)[nb] - ph
            lens = np.linalg.norm(vecs, axis=1)
            radius = 0.5 * float(lens.mean()) if lens.size else 1.0
            ang = np.sort(np.arctan2(vecs[:, 1], vecs[:, 0]))
            gaps = np.diff(np.concatenate([ang, ang[:1] + 2 * np.pi]))
            gi = int(np.argmax(gaps))
            start, width = ang[gi], gaps[gi]
        else:  # isolated host (its only edges went to leaves)
            start, width, radius = 0.0, 2 * np.pi, 1.0
        cnt = j - i
        for t in range(cnt):
            a = start + width * (t + 1) / (cnt + 1)
            pos[leaves[i + t]] = ph + radius * np.array([np.cos(a), np.sin(a)])
        i = j
    return pos
