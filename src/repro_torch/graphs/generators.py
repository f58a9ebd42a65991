"""Benchmark graph generators — the families used by the paper's benchmarks.

RegularGraphs families (Table 1): grids (plain / deficient / crossing-free
variants approximated), cylinders, trees, snowflakes, spiders, sierpinski
triangles, flowers, random grids; RealGraphs/BigGraphs stand-ins: scale-free
(Barabási–Albert), random (GNP), road-like lattices with deletions, and
Delaunay triangulations / triangulated meshes ("hugetric"-like).

All generators return ``(edges[m,2] int64 unique undirected, n)`` in host
numpy; they are deterministic given ``seed``. This module is the port's own
copy of the JAX package's numpy generators: the same seed gives the same
graph in both packages.
"""
from __future__ import annotations

import numpy as np


def _dedup(edges: np.ndarray, n: int) -> np.ndarray:
    e = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    e = e[e[:, 0] != e[:, 1]]
    e = np.sort(e, axis=1)
    e = np.unique(e, axis=0)
    assert e.size == 0 or (e.min() >= 0 and e.max() < n)
    return e


def grid(w: int, h: int, *, periodic_w: bool = False, periodic_h: bool = False,
         drop_frac: float = 0.0, seed: int = 0):
    """w×h lattice. ``periodic_w`` → cylinder; both → torus; ``drop_frac`` →
    'deficient' grids (Grid_*_df families)."""
    idx = np.arange(w * h).reshape(h, w)
    e = []
    e.append(np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1))
    e.append(np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1))
    if periodic_w:
        e.append(np.stack([idx[:, -1].ravel(), idx[:, 0].ravel()], 1))
    if periodic_h:
        e.append(np.stack([idx[-1, :].ravel(), idx[0, :].ravel()], 1))
    edges = np.concatenate(e, axis=0)
    if drop_frac > 0:
        rng = np.random.default_rng(seed)
        keep = rng.random(edges.shape[0]) >= drop_frac
        edges = edges[keep]
    return _dedup(edges, w * h), w * h


def cylinder(circ: int, length: int):
    return grid(circ, length, periodic_w=True)


def torus(w: int, h: int):
    return grid(w, h, periodic_w=True, periodic_h=True)


def tree(arity: int, depth: int):
    """Complete ``arity``-ary tree of the given depth (tree_06_03 ≈ (6,3))."""
    edges = []
    nodes = [0]
    nxt = 1
    for _ in range(depth):
        new_nodes = []
        for u in nodes:
            for _ in range(arity):
                edges.append((u, nxt))
                new_nodes.append(nxt)
                nxt += 1
        nodes = new_nodes
    return _dedup(np.array(edges or np.zeros((0, 2))), nxt), nxt


def snowflake(arms: int, seg: int, depth: int):
    """Koch-flake-like tree: a path of ``seg`` from the center per arm, each
    tip sprouting ``arms`` recursive sub-arms ``depth`` times (m = n-1)."""
    edges = []
    nxt = 1

    def arm(root, d):
        nonlocal nxt
        cur = root
        for _ in range(seg):
            edges.append((cur, nxt))
            cur = nxt
            nxt += 1
        if d > 0:
            for _ in range(arms):
                arm(cur, d - 1)

    for _ in range(arms):
        arm(0, depth)
    return _dedup(np.array(edges), nxt), nxt


def spider(legs: int, leglen: int, hub_cliques: int = 2):
    """Spider: a clique-ish hub of ``hub_cliques*legs`` chords + ``legs``
    paths of length ``leglen`` (spider_A ≈ (8, 11, 2))."""
    edges = []
    nxt = 1
    hub = [0]
    for i in range(legs):
        cur = 0
        for _ in range(leglen):
            edges.append((cur, nxt))
            cur = nxt
            nxt += 1
        hub.append(cur)
    rng = np.random.default_rng(7)
    for _ in range(hub_cliques * legs):
        a, b = rng.choice(len(hub), size=2, replace=False)
        edges.append((hub[a], hub[b]))
    return _dedup(np.array(edges), nxt), nxt


def sierpinski(level: int):
    """Sierpinski triangle graph of the given level."""
    # corners of the initial triangle
    tri = [(0, 1, 2)]
    edges = {(0, 1), (0, 2), (1, 2)}
    nxt = 3
    mid: dict[tuple[int, int], int] = {}

    def midpoint(a, b):
        nonlocal nxt
        key = (min(a, b), max(a, b))
        if key not in mid:
            mid[key] = nxt
            nxt += 1
        return mid[key]

    for _ in range(level):
        new_tri = []
        new_edges = set()
        mid.clear()
        for (a, b, c) in tri:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_tri += [(a, ab, ca), (ab, b, bc), (ca, bc, c), (ab, bc, ca)]
            for (u, v) in [(a, ab), (ab, b), (b, bc), (bc, c), (c, ca), (ca, a),
                           (ab, bc), (bc, ca), (ca, ab)]:
                new_edges.add((min(u, v), max(u, v)))
        tri = [t for t in new_tri]
        edges = new_edges
    return _dedup(np.array(sorted(edges)), nxt), nxt


def flower(petals: int, petal_size: int):
    """Flower: ``petals`` cliques of ``petal_size`` sharing one center vertex
    (flower_001 ≈ dense small graph, flower_005 larger)."""
    edges = []
    nxt = 1
    for _ in range(petals):
        verts = [0] + list(range(nxt, nxt + petal_size))
        nxt += petal_size
        for i in range(len(verts)):
            for j in range(i + 1, len(verts)):
                edges.append((verts[i], verts[j]))
    return _dedup(np.array(edges), nxt), nxt


def random_regular(n: int, d: int, seed: int = 0):
    """d-regular-ish random graph via stub matching (grid_rnd_* stand-in)."""
    rng = np.random.default_rng(seed)
    stubs = np.repeat(np.arange(n), d)
    rng.shuffle(stubs)
    pairs = stubs.reshape(-1, 2)
    return _dedup(pairs, n), n


def gnp(n: int, avg_deg: float, seed: int = 0):
    """Erdős–Rényi with expected average degree ``avg_deg``."""
    rng = np.random.default_rng(seed)
    m = int(n * avg_deg / 2)
    e = rng.integers(0, n, size=(int(m * 1.15) + 8, 2))
    e = _dedup(e, n)
    return e[:m], n


def scale_free(n: int, m_attach: int = 2, seed: int = 0):
    """Barabási–Albert preferential attachment (RealGraphs are mostly
    scale-free: amazon/DBLP/asic). Vectorized repeated-endpoint sampling."""
    rng = np.random.default_rng(seed)
    targets = list(range(m_attach))
    repeated: list[int] = list(range(m_attach))
    edges = []
    for v in range(m_attach, n):
        # sample m_attach targets preferentially from the repeated list
        idx = rng.integers(0, len(repeated), size=m_attach)
        ts = {repeated[i] for i in idx}
        while len(ts) < m_attach:
            ts.add(int(rng.integers(0, v)))
        for t in ts:
            edges.append((v, t))
            repeated.append(t)
        repeated.extend([v] * m_attach)
    return _dedup(np.array(edges), n), n


def delaunay(n: int, seed: int = 0):
    """Delaunay triangulation of random points (delaunay_n22 family)."""
    from scipy.spatial import Delaunay
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    tri = Delaunay(pts)
    s = tri.simplices
    edges = np.concatenate([s[:, [0, 1]], s[:, [1, 2]], s[:, [0, 2]]], axis=0)
    return _dedup(edges, n), n


def tri_mesh(w: int, h: int):
    """Triangulated grid ('hugetric' family): lattice + one diagonal/cell."""
    e_grid, n = grid(w, h)
    idx = np.arange(w * h).reshape(h, w)
    diag = np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1)
    return _dedup(np.concatenate([e_grid, diag], 0), n), n


def road_like(w: int, h: int, drop_frac: float = 0.25, seed: int = 3):
    """Sparse lattice with deletions — roadNet-like degree distribution."""
    return grid(w, h, drop_frac=drop_frac, seed=seed)


def with_degree_one_fringe(edges: np.ndarray, n: int, frac: float = 0.2,
                           seed: int = 0):
    """Attach ``frac*n`` degree-1 vertices (exercises pruning/reinsertion)."""
    rng = np.random.default_rng(seed)
    k = int(frac * n)
    hosts = rng.integers(0, n, size=k)
    fringe = np.arange(n, n + k)
    extra = np.stack([hosts, fringe], axis=1)
    return _dedup(np.concatenate([edges, extra], axis=0), n + k), n + k


# Named suite approximating the paper's benchmark families --------------------

def regulargraphs_suite(small: bool = False):
    """(name, edges, n) tuples — families of the paper's RegularGraphs set.

    ``small=True`` returns reduced sizes for CI-speed tests.
    """
    if small:
        specs = [
            ("grid_8_8", lambda: grid(8, 8)),
            ("tree_3_3", lambda: tree(3, 3)),
            ("cyl_8_6", lambda: cylinder(8, 6)),
            ("sierp_3", lambda: sierpinski(3)),
            ("snow_3_2_1", lambda: snowflake(3, 2, 1)),
            ("spider_4_5", lambda: spider(4, 5)),
            ("flower_4_5", lambda: flower(4, 5)),
            ("rnd_64_4", lambda: random_regular(64, 4, 1)),
        ]
    else:
        specs = [
            ("karate_like", lambda: gnp(34, 4.6, 2)),
            ("grid_20_20", lambda: grid(20, 20)),
            ("grid_20_20_df", lambda: grid(20, 20, drop_frac=0.05, seed=1)),
            ("grid_40_40", lambda: grid(40, 40)),
            ("cylinder_010", lambda: cylinder(10, 10)),
            ("cylinder_032", lambda: cylinder(32, 31)),
            ("tree_06_03", lambda: tree(6, 3)),
            ("tree_06_04", lambda: tree(6, 4)),
            ("snowflake_A", lambda: snowflake(3, 4, 2)),
            ("snowflake_B", lambda: snowflake(4, 5, 3)),
            ("spider_A", lambda: spider(8, 11, 2)),
            ("spider_B", lambda: spider(25, 39, 1)),
            ("sierpinski_04", lambda: sierpinski(4)),
            ("sierpinski_06", lambda: sierpinski(6)),
            ("flower_001", lambda: flower(14, 14)),
            ("grid_rnd_032", lambda: random_regular(985, 4, 5)),
            ("3elt_like", lambda: delaunay(4720, 11)),
            ("uk_like", lambda: road_like(80, 61, 0.30, 4)),
        ]
    return [(name, *fn()) for name, fn in specs]
