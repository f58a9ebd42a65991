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
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.graphs.graph import (PaddedGraph, bucket_pad, edge_gather,
                                      push_max, segment_max, segment_sum)
from repro_torch.utils import prng

UNASSIGNED, SUN, PLANET, MOON = 0, 1, 2, 3
FORCE_EVERY = 4          # every 4th merger round is a forced round


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
    st = init_state(g)
    key = prng.prng_key(seed)
    prev_remaining = g.n + 1
    stalls = 0
    desperate = False
    for r in range(round_budget(g.n)):
        desperate = desperate or stalls >= 2
        key, sub = prng.split(key)
        forced = desperate or r % FORCE_EVERY == FORCE_EVERY - 1
        st = sun_election(g, st, sub, p_sun, forced, not desperate)
        st = system_growth(g, st)
        remaining = int(((st.state == UNASSIGNED) & g.vmask).sum())
        if remaining == 0:
            return st
        stalls = 0 if remaining < prev_remaining else stalls + 1
        prev_remaining = remaining
    return _terminal_forced(st, g.vmask, _ids(g))


@dataclasses.dataclass
class LevelInfo:
    """Record connecting level i to level i+1 (for the placer)."""
    parent_coarse: torch.Tensor  # int32[n_pad_i] — coarse index of v's sun (-1: padding)
    sun_of: torch.Tensor         # int32[n_pad_i] — sun vertex of v (level-i idx)
    depth: torch.Tensor          # int32[n_pad_i]
    state: torch.Tensor          # int32[n_pad_i]
    sun_pos_index: torch.Tensor  # int32[n_coarse] — level-i vertex of each coarse vertex


def next_level(g: PaddedGraph, st: MergerState
               ) -> tuple[PaddedGraph, LevelInfo]:
    """Collapse solar systems into suns → coarse graph, on g's device.

    The semantics of the JAX package's ``next_level_host``: coarse vertices
    = suns in ascending id order (mass = Σ member masses); coarse edges =
    unique inter-system links in ascending (lo, hi) order, weighted by the
    longest member path (depth_u + 1 + depth_v) times the edge weight, max
    over the parallel links. The host reads only the two true sizes, to pick
    the coarse graph's pow2 padding buckets (``bucket_pad``).
    """
    n_pad, dev = g.n_pad, g.device
    vmask = g.vmask
    is_sun = (st.state == SUN) & vmask
    csum = torch.cumsum(is_sun.to(torch.int64), dim=0)
    n_coarse = int(csum[-1])
    new_idx = torch.cat([torch.where(is_sun, csum - 1, -1),
                         torch.full((1,), -1, dtype=torch.int64, device=dev)])
    sun_safe = torch.where(vmask, st.sun, n_pad)
    sun_safe_l = sun_safe.long()
    parent_coarse = new_idx[sun_safe_l]            # -1 for padding rows

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
    plen = (depth_ext[src] + 1 + depth_ext[dst]).to(torch.float32) * g.ewt
    lo = torch.minimum(cu, cv)[cross]
    hi = torch.maximum(cu, cv)[cross]
    keys, inverse = torch.unique(lo * (n_coarse + 1) + hi, sorted=True,
                                 return_inverse=True)
    n_edges = int(keys.shape[0])
    w_max = torch.zeros(n_edges, dtype=torch.float32, device=dev)
    w_max.scatter_reduce_(0, inverse, plen[cross], "amax", include_self=True)
    ce_lo, ce_hi = keys // (n_coarse + 1), keys % (n_coarse + 1)

    # the coarse graph in build_graph's buffer layout
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
