"""Collectives that autograd differentiates through: the port's counterparts
of ``shard_map``'s ``psum``, ``pmean``, ``ppermute``, ``all_to_all`` and
``axis_index``, over the process groups of a ``launch.mesh.Mesh``
(``model_group``, ``vtx_group``, ``axis_groups``, ``Mesh.group(axes)``).

Each is a ``torch.autograd.Function`` whose backward is the transpose
collective, written for the port's convention: every rank computes the
loss whole, so a value that all ranks of a group hold alike (replicated)
has the same gradient on each of them, and a partial value's gradient is
that rank's share. Megatron's conjugate pair is the pattern:

* ``copy_to(x, g)`` — identity forward, all-reduce backward: a replicated
  value entering a region where each rank computes a part (a
  column-parallel product, the rank's heads or experts);
* ``psum(x, g)`` — all-reduce forward, identity backward: the parts summed
  back into a replicated value (after a row-parallel product, a loss's
  global sum).

The sequence-parallel pair ``all_gather`` (reduce-scatter backward) and
``reduce_scatter`` (all-gather backward) replaces them where the residual
is cut along the sequence; ``gather_whole`` (slice backward) and
``scatter`` (all-gather backward) move between a cut and a replicated
tensor. ``ppermute`` and ``all_to_all`` are their own kind's transpose.

No collective here falls back: a failing one raises. A rank never sends to
itself (gloo and NCCL refuse it): ``ppermute`` keeps a self-pair's block
and sends nothing. On ``meta`` tensors (the dry run's fake group, whose
``batch_isend_irecv`` refuses the meta device) ``ppermute`` counts its
bytes and returns what a real group would, as meta tensors, without a
send.

``merge_partials`` is flash-decoding's combine across ranks: each rank's
attention over its block of a sequence-cut KV cache, with the rows'
log-sum-exp, merged over the model group (``merge_partials_local`` is the
same rule on partials stacked along a dimension).

``counting()`` turns on a count of every collective's bytes by kind and
group size (the dry run's: ``launch/roofline.py``), by the ring model of
the JAX package's ``launch/roofline.py``: an all-reduce moves 2(g−1)/g of
its size a rank, an all-gather, reduce-scatter or all-to-all (g−1)/g of the
whole, a permute its size. Off, it costs one test of a flag a collective.
"""
from __future__ import annotations

import collections
import contextlib

import torch
import torch.distributed as dist

#: (kind, group size) → bytes a rank moves, while ``counting`` is on
coll_bytes: collections.Counter | None = None


@contextlib.contextmanager
def counting():
    """Within ``with``: every collective of this module (and those that
    ``record`` is told of) adds its ring-model bytes to ``coll_bytes``,
    which starts empty; yields the counter."""
    global coll_bytes
    prev, coll_bytes = coll_bytes, collections.Counter()
    try:
        yield coll_bytes
    finally:
        coll_bytes = prev


_RING = {"all-reduce": lambda g: 2.0 * (g - 1) / g,
         "all-gather": lambda g: (g - 1) / g,
         "reduce-scatter": lambda g: (g - 1) / g,
         "all-to-all": lambda g: (g - 1) / g,
         "collective-permute": lambda g: 1.0}


def record(kind: str, nbytes: int, group) -> None:
    """Count a collective of ``kind`` over ``group`` whose largest side
    (input or output) holds ``nbytes``, when ``counting`` is on."""
    if coll_bytes is None:
        return
    g = size(group)
    if g > 1:
        coll_bytes[(kind, g)] += _RING[kind](g) * nbytes


def _nbytes(x) -> int:
    return x.numel() * x.element_size()


# the single-tensor all-gather and reduce-scatter: torch 2.13 names them
# *_single and deprecates the *_tensor names that older releases have
_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_scatter_into = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def size(group) -> int:
    return dist.get_world_size(group)


def rank(group) -> int:
    return dist.get_rank(group)


def _all_reduce(x, group, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    record("all-reduce", _nbytes(out), group)
    dist.all_reduce(out, op=op, group=group)
    return out


def _gather(x, group, dim: int):
    n = size(group)
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((n * x.shape[0], *x.shape[1:]))
    record("all-gather", _nbytes(out), group)
    _gather_into(out, x, group=group)
    return out.movedim(0, dim)


def _reduce_scatter(x, group, dim: int):
    n = size(group)
    x = x.movedim(dim, 0).contiguous()
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: {x.shape[0]} rows over {n} ranks")
    out = x.new_empty((x.shape[0] // n, *x.shape[1:]))
    record("reduce-scatter", _nbytes(x), group)
    _scatter_into(out, x, group=group)
    return out.movedim(0, dim)


def _own(x, group, dim: int):
    n, r = size(group), rank(group)
    b = x.shape[dim] // n
    if b * n != x.shape[dim]:
        raise ValueError(f"scatter: {x.shape[dim]} rows over {n} ranks")
    return x.narrow(dim, r * b, b)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, whole_below):
        ctx.group, ctx.dim, ctx.whole = group, dim, whole_below
        return _gather(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        if ctx.whole:
            return _own(g, ctx.group, ctx.dim).contiguous(), None, None, None
        return _reduce_scatter(g, ctx.group, ctx.dim), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _reduce_scatter(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


class _Scatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _own(x, group, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group, ctx.dim), None, None


def psum(x, group):
    """Σ over the group's ranks (all-reduce); backward: the identity."""
    return _Psum.apply(x, group)


def pmean(x, group):
    """The group's mean: ``psum(x) / size``."""
    return psum(x, group) / size(group)


def pmax(x, group):
    """The group's elementwise max, outside autograd (a logsumexp's
    shift)."""
    return _all_reduce(x.detach(), group, dist.ReduceOp.MAX)


def copy_to(x, group):
    """The identity; backward: the all-reduce of the ranks' parts of the
    gradient."""
    return _CopyTo.apply(x, group)


def all_gather(x, group, dim: int):
    """The ranks' blocks concatenated along ``dim`` (rank order), for a
    region that computes parts: backward, the reduce-scatter."""
    return _AllGather.apply(x, group, dim, False)


def gather_whole(x, group, dim: int):
    """The ranks' blocks concatenated along ``dim``, for a region every rank
    computes whole: backward, this rank's block of the gradient."""
    return _AllGather.apply(x, group, dim, True)


def reduce_scatter(x, group, dim: int):
    """Σ over the ranks, cut along ``dim``: this rank's block; backward,
    the all-gather."""
    return _ReduceScatter.apply(x, group, dim)


def scatter(x, group, dim: int):
    """This rank's block of a replicated ``x`` along ``dim``; backward, the
    all-gather."""
    return _Scatter.apply(x, group, dim)


def _permute(x, group, pairs):
    """Send ``x`` along ``pairs`` ((source, destination) group ranks) →
    what this rank receives, zeros where it is no destination."""
    me = rank(group)
    x = x.contiguous()
    out = None
    ops = []
    for src, dst in pairs:
        if src == me and dst == me:
            out = x.clone()
        elif src == me:
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            out = torch.empty_like(x)
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        record("collective-permute", _nbytes(x), group)
        if x.device.type != "meta":         # a fake group moves nothing
            for req in dist.batch_isend_irecv(ops):
                req.wait()
    return torch.zeros_like(x) if out is None else out


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, pairs):
        ctx.group, ctx.pairs = group, pairs
        return _permute(x, group, pairs)

    @staticmethod
    def backward(ctx, g):
        back = tuple((d, s) for s, d in ctx.pairs)
        return _permute(g, ctx.group, back), None, None


def ppermute(x, group, perm):
    """JAX's ``ppermute``: each (source, destination) pair of group ranks
    in ``perm`` sends the source's ``x`` to the destination; a rank that is
    no destination receives zeros. Backward: the inverse permutation. Every
    rank of the group must call it with the same ``perm``."""
    return _Ppermute.apply(x, group, tuple((int(s), int(d)) for s, d in perm))


def _a2a(x, group, dim: int):
    n = size(group)
    if x.shape[dim] != n:
        raise ValueError(f"all_to_all: dim {dim} has {x.shape[dim]} blocks "
                         f"for {n} ranks")
    x = x.movedim(dim, 0).contiguous()
    out = torch.empty_like(x)
    record("all-to-all", _nbytes(x), group)
    dist.all_to_all_single(out, x, group=group)
    return out.movedim(0, dim)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _a2a(x, group, dim)

    @staticmethod
    def backward(ctx, g):
        return _a2a(g, ctx.group, ctx.dim), None, None


def all_to_all(x, group, dim: int):
    """JAX's ``all_to_all`` with ``split_axis == concat_axis == dim``:
    ``x.shape[dim]`` is the group's size, block j goes to rank j, and block
    j of the result came from rank j. Its own transpose."""
    return _AllToAll.apply(x, group, dim)


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on ``axis``."""
    return mesh.axis_index(axis)


def merge_partials_local(out, lse, dim: int = 0):
    """Partial attentions stacked along ``dim`` — out [..., Sq, H, hd] in
    the activation dtype, each over its own block of the keys, and lse
    [..., Sq, H] float32, its rows' log-sum-exp — merged into the attention
    over all the keys: weights exp(lse − max lse) over the partials, the
    weighted sum of the outputs over the sum of the weights, in float32,
    cast to out's dtype at the end. A partial that saw no key (lse −inf)
    weighs 0; a row no partial saw gives 0."""
    mx = lse.amax(dim, keepdim=True)
    w = torch.where(torch.isfinite(mx), torch.exp(lse - mx), 0.0)
    num = (out.float() * w[..., None]).sum(dim)
    den = w.sum(dim)
    return (num / den.clamp_min(1e-30)[..., None]).to(out.dtype)


def merge_partials(out, lse, group):
    """``merge_partials_local`` over the ranks of ``group``: each rank's
    partial out [B, Sq, H, hd] and lse [B, Sq, H] → the merged attention,
    the same on every rank — a ``pmax`` of lse, then one all-reduce of the
    weighted outputs beside the weights (float32). A one-rank group returns
    ``out`` unchanged. Outside autograd (serving)."""
    if size(group) == 1:
        return out
    mx = pmax(lse, group)
    w = torch.where(torch.isfinite(mx), torch.exp(lse - mx), 0.0)
    both = _all_reduce(torch.cat([out.float() * w[..., None],
                                  w[..., None]], dim=-1), group)
    return (both[..., :-1] / both[..., -1:].clamp_min(1e-30)).to(out.dtype)
