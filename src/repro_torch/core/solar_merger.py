"""Distributed Solar Merger — the coarsening phase of Multi-GiLA (paper §3.2).

Vertex-centric BSP protocol as dense tensor supersteps, the JAX package's
``core/solar_merger.py`` on torch:

  1. *Sun generation*: unassigned vertices self-elect with probability p;
     conflicts within graph distance < 3 are resolved by ID (two max-
     propagation supersteps — a sun survives iff it is the strict 2-hop
     maximum among candidates).
  2. *Solar-system generation*: suns broadcast offers; unassigned neighbors
     become planets of the max-ID offering sun; planets forward offers;
     unassigned 2-hop vertices become moons.
  3. Steps 1–2 repeat until no vertex is unassigned (every 4th round is
     *forced*; a stalled vote switches to sticky desperation mode).
  4. *Next-level generation*: systems collapse into their suns; coarse-edge
     weight = max path length over the parallel links.

The round loop follows the JAX package's per-round host driver
(``run_merger_host``): one ``split`` of the host key per round and one read
of the halting vote per round. Every message combine is a
``scatter_reduce("amax")``. All of it is integer arithmetic, so the
hierarchy is bit-identical to the JAX package's on any device.

Observability, as in the JAX package: ``gila_merger_rounds_total`` and
``gila_merger_forced_suns_total`` count the rounds run and the vertices
that the terminal forced round made suns. Of the JAX package's three
device-dispatch spans, ``merger.dispatch`` brackets the round loop (the
JAX package's one cached program; here the per-round loop, whose halting
votes are already its host syncs), and ``coarsen.compact`` /
``coarsen.assemble`` bracket ``next_level``'s compaction up to its read of
the two true sizes and the coarse graph's assembly at its buckets. The
JAX package labels them with the cached program's key; the port caches no
program there, so they carry the shape (``n_pad``) instead. The
exact-shape path (``next_level_host``) has no span, as in the JAX package.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graphs.graph import (PaddedGraph, bucket_pad, build_graph,
                                      edge_gather, push_max, segment_max,
                                      segment_sum, to_csr)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.utils import prng

UNASSIGNED, SUN, PLANET, MOON = 0, 1, 2, 3
FORCE_EVERY = 4          # every 4th merger round is a forced round

MERGER_ROUNDS = obs_metrics.REGISTRY.counter(
    "gila_merger_rounds_total",
    "BSP election+growth rounds executed inside the device merger loop")
MERGER_FORCED_SUNS = obs_metrics.REGISTRY.counter(
    "gila_merger_forced_suns_total",
    "Vertices self-elected by the terminal forced round (round-budget "
    "exhaustion — the documented graceful-degradation deviation)")


@dataclasses.dataclass(frozen=True)
class MergerState:
    """Per-vertex solar-system assignment (padding rows stay UNASSIGNED but
    are masked out by g.vmask everywhere)."""
    state: torch.Tensor   # int32[n_pad] — UNASSIGNED/SUN/PLANET/MOON
    sun: torch.Tensor     # int32[n_pad] — index of the system's sun (n_pad = none)
    depth: torch.Tensor   # int32[n_pad] — hops to the sun (0/1/2)
    parent: torch.Tensor  # int32[n_pad] — next hop toward the sun


def init_state(g: PaddedGraph) -> MergerState:
    n_pad, dev = g.n_pad, g.device
    full = lambda v: torch.full((n_pad,), v, dtype=torch.int32, device=dev)
    return MergerState(state=full(UNASSIGNED), sun=full(n_pad),
                       depth=full(-1), parent=full(n_pad))


def _ids(g: PaddedGraph) -> torch.Tensor:
    return torch.arange(g.n_pad, dtype=torch.int32, device=g.device)


def sun_election(g: PaddedGraph, st: MergerState, key, p: float,
                 forced: bool, respect_existing: bool) -> MergerState:
    """One sun-generation round. Existing suns take part in the conflict
    broadcast with dominating priority (ID + n_pad) unless
    ``respect_existing`` is False (desperation mode, radius 1 hop)."""
    n_pad = g.n_pad
    ids = _ids(g)
    unassigned = (st.state == UNASSIGNED) & g.vmask
    coin = prng.uniform_per_vertex(key, ids) < torch.tensor(
        np.float32(p), device=g.device)
    cand = unassigned & (coin | forced)

    sun_prio = (torch.where(st.state == SUN, ids + n_pad, -1)
                if respect_existing else torch.full_like(ids, -1))
    h0 = torch.maximum(torch.where(cand, ids, -1), sun_prio)
    h1 = torch.maximum(h0, push_max(g, h0))
    h_conflict = torch.maximum(h1, push_max(g, h1)) if respect_existing else h1
    new_sun = cand & (h_conflict <= ids)

    return MergerState(state=torch.where(new_sun, SUN, st.state),
                       sun=torch.where(new_sun, ids, st.sun),
                       depth=torch.where(new_sun, 0, st.depth),
                       parent=torch.where(new_sun, ids, st.parent))


def system_growth(g: PaddedGraph, st: MergerState) -> MergerState:
    """One solar-system-generation round (offers → planets → moons)."""
    n_pad = g.n_pad
    ids = _ids(g)
    unassigned = (st.state == UNASSIGNED) & g.vmask

    # superstep A: unassigned neighbors of suns accept the max-ID offer
    offer1 = push_max(g, torch.where(st.state == SUN, ids, -1))
    becomes_planet = unassigned & (offer1 >= 0)
    state = torch.where(becomes_planet, PLANET, st.state)
    sun = torch.where(becomes_planet, offer1, st.sun)
    depth = torch.where(becomes_planet, 1, st.depth)
    parent = torch.where(becomes_planet, offer1, st.parent)

    # superstep B: planets forward their sun's offer; the rest become moons,
    # routed through the max-ID planet that forwarded the accepted offer
    planet_fwd = torch.where(state == PLANET, sun, -1)
    offer2 = push_max(g, planet_fwd)
    becomes_moon = unassigned & ~becomes_planet & (offer2 >= 0)
    match_val = torch.where(state == PLANET, ids, -1)
    msgs = edge_gather(g, torch.stack([planet_fwd, match_val], dim=1))
    dst_c = torch.clamp(g.dst_l, 0, n_pad - 1)
    key_match = torch.where(
        g.emask & (msgs[:, 0] >= 0) & (msgs[:, 0] == offer2[dst_c])
        & (g.dst < n_pad), msgs[:, 1], -1)
    via = segment_max(key_match, g.dst_l, n_pad + 1, -1)[:n_pad]

    return MergerState(state=torch.where(becomes_moon, MOON, state),
                       sun=torch.where(becomes_moon, offer2, sun),
                       depth=torch.where(becomes_moon, 2, depth),
                       parent=torch.where(becomes_moon, via, parent))


def round_budget(n: int) -> int:
    """Merger round budget: 96 rounds, plus 8 per doubling past 4096."""
    n = max(int(n), 2)
    extra = max(0, int(np.ceil(np.log2(n / 4096))) * 8) if n > 4096 else 0
    return 96 + extra


def _terminal_forced(st: MergerState, vmask: torch.Tensor,
                     ids: torch.Tensor) -> MergerState:
    """Any vertex still unassigned after the round budget becomes its own
    sun (identity when the merger converged)."""
    left = (st.state == UNASSIGNED) & vmask
    return MergerState(state=torch.where(left, SUN, st.state),
                       sun=torch.where(left, ids, st.sun),
                       depth=torch.where(left, 0, st.depth),
                       parent=torch.where(left, ids, st.parent))


def run_merger(g: PaddedGraph, *, p_sun: float = 0.35, seed: int = 0
               ) -> MergerState:
    """Election + growth rounds until every valid vertex is assigned.

    The control flow of the JAX package's ``run_merger_host``: one host
    ``split`` per round, a forced round every ``FORCE_EVERY``, two stalled
    votes switch on sticky desperation, and an exhausted ``round_budget``
    ends in the terminal forced round. The halting vote is read once per
    round.
    """
    with obs_trace.span("merger.dispatch", cat="device", n_pad=g.n_pad):
        st, rounds, left = _merger_rounds(g, p_sun, seed)
    MERGER_ROUNDS.inc(rounds)
    if left:
        MERGER_FORCED_SUNS.inc(left)
    return st


def _merger_rounds(g: PaddedGraph, p_sun: float, seed: int) -> tuple:
    """(state, rounds run, vertices left to the terminal forced round)."""
    st = init_state(g)
    key = prng.prng_key(seed)
    prev_remaining = g.n + 1
    stalls = 0
    desperate = False
    budget = round_budget(g.n)
    for r in range(budget):
        desperate = desperate or stalls >= 2
        key, sub = prng.split(key)
        forced = desperate or r % FORCE_EVERY == FORCE_EVERY - 1
        st = sun_election(g, st, sub, p_sun, forced, not desperate)
        st = system_growth(g, st)
        remaining = int(((st.state == UNASSIGNED) & g.vmask).sum())
        if remaining == 0:
            return st, r + 1, 0
        stalls = 0 if remaining < prev_remaining else stalls + 1
        prev_remaining = remaining
    return _terminal_forced(st, g.vmask, _ids(g)), budget, remaining


@dataclasses.dataclass
class LevelInfo:
    """Record connecting level i to level i+1 (for the placer)."""
    parent_coarse: torch.Tensor  # int32[n_pad_i] — coarse index of v's sun (-1: padding)
    sun_of: torch.Tensor         # int32[n_pad_i] — sun vertex of v (level-i idx)
    depth: torch.Tensor          # int32[n_pad_i]
    state: torch.Tensor          # int32[n_pad_i]
    sun_pos_index: torch.Tensor  # int32[n_coarse] — level-i vertex of each coarse vertex


def next_level(g: PaddedGraph, st: MergerState, *, bucket: bool = True
               ) -> tuple[PaddedGraph, LevelInfo]:
    """Collapse solar systems into suns → coarse graph, on g's device.

    The semantics of the JAX package's ``next_level_host``: coarse vertices
    = suns in ascending id order (mass = Σ member masses); coarse edges =
    unique inter-system links in ascending (lo, hi) order, weighted by the
    longest member path (depth_u + 1 + depth_v) times the edge weight, max
    over the parallel links. ``bucket=True`` (the bucketed driver) compacts
    on the device and reads only the two true sizes, to pick the coarse
    graph's pow2 padding buckets (``bucket_pad``); ``bucket=False`` is the
    exact-shape path, ``next_level_host``.
    """
    if not bucket:
        return next_level_host(g, st)
    n_pad, dev = g.n_pad, g.device
    with obs_trace.span("coarsen.compact", cat="device", n_pad=n_pad):
        vmask = g.vmask
        is_sun = (st.state == SUN) & vmask
        csum = torch.cumsum(is_sun.to(torch.int64), dim=0)
        n_coarse = int(csum[-1])
        new_idx = torch.cat([torch.where(is_sun, csum - 1, -1),
                             torch.full((1,), -1, dtype=torch.int64,
                                        device=dev)])
        sun_safe = torch.where(vmask, st.sun, n_pad)
        sun_safe_l = sun_safe.long()
        parent_coarse = new_idx[sun_safe_l]        # -1 for padding rows

        # coarse masses: Σ member masses per sun (integer-valued, so exact)
        member = vmask & (parent_coarse >= 0)
        cmass = segment_sum(torch.where(member, g.mass, 0.0),
                            torch.where(member, parent_coarse, n_coarse),
                            n_coarse + 1)[:n_coarse]

        # inter-system links → coarse edges
        src, dst = g.src_l, g.dst_l
        e_ok = g.emask & (src < n_pad) & (dst < n_pad)
        sun_ext = torch.cat([sun_safe_l, sun_safe_l.new_full((1,), n_pad)])
        depth_ext = torch.cat([st.depth, st.depth.new_zeros((1,))])
        su, sv = sun_ext[src], sun_ext[dst]
        cross = e_ok & (su != sv)
        cu, cv = new_idx[su], new_idx[sv]
        plen = ((depth_ext[src] + 1 + depth_ext[dst]).to(torch.float32)
                * g.ewt)
        lo = torch.minimum(cu, cv)[cross]
        hi = torch.maximum(cu, cv)[cross]
        keys, inverse = torch.unique(lo * (n_coarse + 1) + hi, sorted=True,
                                     return_inverse=True)
        n_edges = int(keys.shape[0])
        w_max = torch.zeros(n_edges, dtype=torch.float32, device=dev)
        w_max.scatter_reduce_(0, inverse, plen[cross], "amax",
                              include_self=True)
        ce_lo, ce_hi = keys // (n_coarse + 1), keys % (n_coarse + 1)

    # the coarse graph in build_graph's buffer layout
    with obs_trace.span("coarsen.assemble", cat="device", n_coarse=n_coarse,
                        n_edges=n_edges):
        n_pad_c = bucket_pad(n_coarse)
        m_pad_c = bucket_pad(2 * n_edges)
        pad = m_pad_c - 2 * n_edges
        fill = lambda v, dt: torch.full((pad,), v, dtype=dt, device=dev)
        c_src = torch.cat([ce_lo, ce_hi]).to(torch.int32)
        c_dst = torch.cat([ce_hi, ce_lo]).to(torch.int32)
        cg = PaddedGraph(
            src=torch.cat([c_src, fill(n_pad_c, torch.int32)]),
            dst=torch.cat([c_dst, fill(n_pad_c, torch.int32)]),
            vmask=torch.arange(n_pad_c, device=dev) < n_coarse,
            emask=torch.arange(m_pad_c, device=dev) < 2 * n_edges,
            mass=torch.cat([cmass, cmass.new_zeros((n_pad_c - n_coarse,))]),
            ewt=torch.cat([w_max, w_max, fill(1.0, torch.float32)]),
            n=n_coarse, m=n_edges)
        info = LevelInfo(
            parent_coarse=parent_coarse[:n_pad].to(torch.int32),
            sun_of=sun_safe.to(torch.int32),
            depth=st.depth.clone(), state=st.state.clone(),
            sun_pos_index=torch.nonzero(is_sun).flatten().to(torch.int32))
    return cg, info


def next_level_host(g: PaddedGraph, st: MergerState
                    ) -> tuple[PaddedGraph, LevelInfo]:
    """Host-numpy compaction with round-256 padding: the JAX package's
    ``next_level_host(bucket=False)``, line for line, its result moved to
    g's device."""
    n_pad, dev = g.n_pad, g.device
    state = st.state.cpu().numpy()
    sun = st.sun.cpu().numpy()
    depth = st.depth.cpu().numpy()
    vmask = g.vmask.cpu().numpy()
    mass = g.mass.cpu().numpy()
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    emask = g.emask.cpu().numpy()
    ewt = g.ewt.cpu().numpy()

    is_sun = (state == SUN) & vmask
    n_coarse = int(is_sun.sum())
    new_idx = np.full((n_pad + 1,), -1, dtype=np.int64)
    new_idx[:n_pad][is_sun] = np.arange(n_coarse)
    sun_safe = np.where(vmask, sun, n_pad)
    parent_coarse = new_idx[sun_safe]  # -1 for padding rows

    # coarse masses
    cmass = np.zeros((n_coarse,), dtype=np.float32)
    member = vmask & (parent_coarse >= 0)
    np.add.at(cmass, parent_coarse[member], mass[member])

    # inter-system links → coarse edges
    e_ok = emask & (src < n_pad) & (dst < n_pad)
    su, sv = sun_safe[src[e_ok]], sun_safe[dst[e_ok]]
    cross = su != sv
    cu = new_idx[su[cross]]
    cv = new_idx[sv[cross]]
    plen = (depth[src[e_ok]][cross] + 1
            + depth[dst[e_ok]][cross]).astype(np.float32)
    plen = plen * ewt[e_ok][cross]  # compound desired lengths across levels
    lo = np.minimum(cu, cv)
    hi = np.maximum(cu, cv)
    key = lo * (n_coarse + 1) + hi
    order = np.argsort(key)
    key_s, lo_s, hi_s, w_s = key[order], lo[order], hi[order], plen[order]
    if key_s.size:
        uniq_mask = np.concatenate([[True], key_s[1:] != key_s[:-1]])
        seg_id = np.cumsum(uniq_mask) - 1
        n_edges = int(seg_id[-1]) + 1
        w_max = np.zeros((n_edges,), np.float32)
        np.maximum.at(w_max, seg_id, w_s)
        ce = np.stack([lo_s[uniq_mask], hi_s[uniq_mask]], axis=1)
    else:
        ce = np.zeros((0, 2), np.int64)
        w_max = np.zeros((0,), np.float32)

    sun_pos_index = np.nonzero(is_sun)[0].astype(np.int32)
    cg = build_graph(ce, n_coarse, mass=cmass, ewt=w_max, bucket=False,
                     device=dev)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    info = LevelInfo(
        parent_coarse=t(parent_coarse[:n_pad].astype(np.int32)),
        sun_of=t(sun_safe[:n_pad].astype(np.int32)),
        depth=t(depth.astype(np.int32)), state=t(state.astype(np.int32)),
        sun_pos_index=t(sun_pos_index))
    return cg, info


def centralized_solar_merger(edges: np.ndarray, n: int, seed: int = 0
                             ) -> tuple[np.ndarray, int]:
    """Sequential Solar Merger reference (FM³'s greedy, Hachul 2005):
    visit vertices in random order; an unassigned vertex becomes a sun and
    absorbs its unassigned ≤2-hop neighborhood (planets then moons).
    Returns (sun_of[n], n_suns) — used for the Fig.5 level-count baseline.
    """
    rng = np.random.default_rng(seed)
    row_ptr, col = to_csr(edges, n)
    sun_of = np.full(n, -1, dtype=np.int64)
    n_suns = 0
    for v in rng.permutation(n):
        if sun_of[v] >= 0:
            continue
        sun_of[v] = v
        n_suns += 1
        planets = [u for u in col[row_ptr[v]:row_ptr[v + 1]]
                   if sun_of[u] < 0]
        for u in planets:
            sun_of[u] = v
        for u in planets:
            for w in col[row_ptr[u]:row_ptr[u + 1]]:
                if sun_of[w] < 0:
                    sun_of[w] = v
    return sun_of, n_suns


def centralized_levels(edges: np.ndarray, n: int, *, threshold: int = 50,
                       max_levels: int = 24, seed: int = 0) -> list[int]:
    """Level sizes produced by iterating the centralized Solar Merger.

    Each level derives its own seed (``seed + 101 * lvl``, mirroring
    ``build_hierarchy``), so the coarsening decisions of successive levels
    are not correlated through one visiting permutation.
    """
    sizes = [n]
    cur_edges, cur_n = edges, n
    for lvl in range(max_levels):
        if cur_n <= threshold or len(cur_edges) == 0:
            break
        sun_of, n_suns = centralized_solar_merger(cur_edges, cur_n,
                                                  seed + 101 * lvl)
        if n_suns >= cur_n:
            break
        new_idx = np.full(cur_n, -1, dtype=np.int64)
        suns = np.unique(sun_of)
        new_idx[suns] = np.arange(len(suns))
        ce = new_idx[sun_of[cur_edges]]
        ce = ce[ce[:, 0] != ce[:, 1]]
        ce = np.unique(np.sort(ce, axis=1), axis=0) if len(ce) else ce
        cur_edges, cur_n = ce, len(suns)
        sizes.append(cur_n)
    return sizes
