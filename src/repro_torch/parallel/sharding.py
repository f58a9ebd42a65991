"""Sharding rules for the LM zoo (DP/TP/EP/SP + pod): the JAX package's
``parallel/sharding.py`` over the port's ``launch.mesh.Mesh``.

The mesh is (pod, data, model) — multi-pod — or (data, model).
``ShardingRules`` keeps the JAX package's fields and meanings:

  batch   → ("pod", "data")         (DP; pod is an outer DP axis)
  heads   → "model" when n_heads % model_size == 0, else whole
  mlp/vocab/ssm-inner → "model"     (Megatron TP)
  experts → "model" when n_experts % model_size == 0 (EP), else expert FFNs
            TP-cut inside each expert (``expert_tp``)
  kv_seq  → "model" for decode KV caches when the KV heads are not cut
            (flash-decoding: each rank attends over its block of the cache
            and ``comm.merge_partials`` combines the ranks)

A spec is a tuple with one entry a dimension: None (whole), a mesh axis, or
a tuple of axes. ``make_rules`` and ``zero_spec`` return the JAX package's
values. Where JAX lays a parameter out by ``NamedSharding`` and lets GSPMD
insert the collectives, the port holds each rank's block of it (the
``Shardings`` of ``param_shardings``: ``shard`` cuts a full leaf, ``gather``
puts the blocks back together) and its sharded forward
(``models/model.py``) calls the collectives of ``parallel/comm.py`` where
each layout changes. A dimension that does not divide its axes is cut into
blocks of ⌈n / size⌉ rows, the last ones shorter, as ``NamedSharding``
pads. ``strategy="fsdp_dp"`` runs pure DP over data × model; the port keeps
each parameter whole on every rank (the JAX package stores them ZeRO-3 cut
only in the dry run), which gives the same numbers.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading

import torch
import torch.distributed as dist

from repro_torch.parallel import comm

_STATE = threading.local()


@dataclasses.dataclass(frozen=True)
class ShardingRules:
    mesh: object | None            # a launch.mesh.Mesh
    batch: tuple | None            # mesh axes for the batch dim
    tp: str | None                 # "model" or None
    heads: str | None              # q-head sharding
    kv_heads: str | None
    experts: str | None            # EP axis
    expert_tp: str | None          # TP inside experts (granite fallback)
    kv_seq: str | None             # decode cache sequence sharding
    seq: str | None = None         # Megatron-SP: residual seq sharding
    moe_impl: str = "gspmd"        # gspmd | shard_map | all_to_all


def make_rules(mesh, cfg=None, *, seq_shard: bool = False,
               strategy: str = "tp", moe_impl: str = "gspmd") -> ShardingRules:
    """strategy "tp" = Megatron TP over the model axis (default);
    "fsdp_dp" = the model axis joins the batch axes (pure DP). Reads only
    ``mesh.axis_names`` and ``mesh.shape``."""
    if mesh is None:
        return ShardingRules(None, None, None, None, None, None, None, None)
    model = "model" if "model" in mesh.axis_names else None
    msize = mesh.shape["model"] if model else 1
    if strategy == "fsdp_dp":
        batch = ("data", "model")
        experts = None
        if (cfg is not None and cfg.moe is not None and model
                and moe_impl == "all_to_all"
                and cfg.moe.n_experts % msize == 0):
            experts = model      # EP via a2a rides the model axis
        return ShardingRules(mesh=mesh, batch=batch, tp=None, heads=None,
                             kv_heads=None, experts=experts, expert_tp=None,
                             kv_seq=None, seq=None, moe_impl=moe_impl)
    batch = ("pod", "data") if "pod" in mesh.axis_names else ("data",)
    heads = kv_heads = None
    experts = expert_tp = None
    if cfg is not None and model:
        if cfg.n_heads and cfg.n_heads % msize == 0:
            heads = model
            if cfg.n_kv_heads and cfg.n_kv_heads % msize == 0:
                kv_heads = model
        if cfg.moe is not None:
            if cfg.moe.n_experts % msize == 0:
                experts = model
            else:
                expert_tp = model
    return ShardingRules(mesh=mesh, batch=batch, tp=model, heads=heads,
                         kv_heads=kv_heads, experts=experts,
                         expert_tp=expert_tp, kv_seq=model,
                         seq=model if seq_shard else None,
                         moe_impl=moe_impl)


@contextlib.contextmanager
def use_shardings(mesh, rules: ShardingRules | None):
    """Within ``with``: ``current_rules()`` is ``rules`` (on this thread)."""
    prev = getattr(_STATE, "rules", None)
    _STATE.rules = rules
    try:
        yield
    finally:
        _STATE.rules = prev


def current_rules() -> ShardingRules | None:
    return getattr(_STATE, "rules", None)


def current_mesh():
    r = current_rules()
    return r.mesh if r else None


def batch_axes() -> tuple | None:
    r = current_rules()
    return r.batch if r else None


def active(r: ShardingRules | None) -> bool:
    """Whether ``r`` shards anything (rules with a mesh)."""
    return r is not None and r.mesh is not None


def _batch_spec(rules: ShardingRules, B: int):
    """The batch axes that cut B rows (the JAX package's dry run's
    ``_batch_spec``): ``rules.batch`` when B divides their size, else None
    (whole: ``long_500k``'s one row)."""
    dp = 1
    for a in rules.batch:
        dp *= rules.mesh.shape[a]
    return rules.batch if B % dp == 0 else None


def decode_state_specs(cfg, rules: ShardingRules, B: int) -> list:
    """The spec of each layer's decode state (``models.model.
    init_decode_state``'s list of pairs), the JAX package's
    ``decode_state_specs`` without the scan's group axis: an attention
    layer's (k, v) [B, S, KV, hd] cut over ``rules.kv_heads``, or, when the
    KV heads are not cut, along the sequence over ``rules.kv_seq``
    (flash-decoding); an SSD layer's conv [B, W−1, channels] over "model"
    when the channels divide it, its h [B, H, N, P] over "model" when the
    heads do; the batch by ``_batch_spec``."""
    bs = _batch_spec(rules, B)
    msize = rules.mesh.shape["model"]
    if rules.kv_heads is not None:
        kv = (bs, None, rules.kv_heads, None)
    else:
        kv = (bs, rules.kv_seq, None, None)
    out = []
    for i in range(cfg.n_layers):
        if cfg.layer_pattern()[i % len(cfg.layer_pattern())] == "attn":
            out.append((kv, kv))
            continue
        d_inner = cfg.ssm.expand * cfg.d_model
        H = d_inner // cfg.ssm.head_dim
        ch = d_inner + 2 * cfg.ssm.n_groups * cfg.ssm.d_state
        out.append(((bs, None, "model" if ch % msize == 0 else None),
                    (bs, "model" if H % msize == 0 else None, None, None)))
    return out


def zero_spec(spec, shape, mesh, axes=("pod", "data")) -> tuple:
    """ZeRO/FSDP: additionally cut the first free, divisible dim over the DP
    axes (the JAX package's; the port's trainer keeps parameters whole)."""
    axes = tuple(a for a in axes if a in mesh.axis_names)
    dp = 1
    for a in axes:
        dp *= mesh.shape[a]
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for d, (e, s) in enumerate(zip(entries, shape)):
        if e is None and s % dp == 0 and s >= dp:
            entries[d] = axes if len(axes) > 1 else axes[0]
            return tuple(entries)
    return tuple(spec)


def zero_shardings(mesh, specs: dict, shapes: dict) -> dict:
    """{name: ``zero_spec``} of every spec, at its leaf's shape."""
    return {k: zero_spec(s, tuple(shapes[k]), mesh) for k, s in specs.items()}


# -- blocks ---------------------------------------------------------------------

def spec_axes(entry) -> tuple:
    """The mesh axes of one spec entry (None → ())."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def block_range(n: int, parts: int, i: int) -> tuple:
    """[lo, hi) of block ``i`` of ``n`` rows cut into ``parts`` blocks of
    ⌈n / parts⌉ rows (the last ones shorter, possibly empty)."""
    b = -(-n // parts)
    return min(i * b, n), min((i + 1) * b, n)


def dim_range(mesh, entry, n: int) -> tuple:
    """[lo, hi) of this rank's block of a dimension of ``n`` rows that the
    spec entry ``entry`` cuts."""
    axes = spec_axes(entry)
    return block_range(n, mesh.axis_size(axes), mesh.index(axes))


def shard_leaf(full: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of ``full`` under ``spec`` (a copy)."""
    out = full
    for d, entry in enumerate(spec):
        if spec_axes(entry):
            lo, hi = dim_range(mesh, entry, full.shape[d])
            out = out.narrow(d, lo, hi - lo)
    return out.clone()


def gather_leaf(block: torch.Tensor, spec, mesh, shape) -> torch.Tensor:
    """The full leaf of ``shape`` from every rank's block under ``spec``
    (a collective over each cut dimension's axes)."""
    out = block.detach()
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if not axes:
            continue
        parts = mesh.axis_size(axes)
        b = -(-shape[d] // parts)
        pad = [0, 0] * (out.dim() - d - 1) + [0, b - out.shape[d]]
        padded = torch.nn.functional.pad(out, pad)
        out = comm._gather(padded, mesh.group(axes), d).narrow(d, 0,
                                                                shape[d])
    return out.contiguous()


class Shardings:
    """The port's ``param_shardings``: where each named leaf lies on the
    mesh. ``shard(name, full)`` cuts a full leaf to this rank's block (and
    records the full shape), ``gather(name, block)`` puts the blocks back
    together on every rank; a name without a spec, or a tree path whose
    last component is none, passes whole. The optimizer state's leaves
    carry their parameter's name, so the same object serves them."""

    def __init__(self, mesh, specs: dict):
        self.mesh, self.specs, self.shapes = mesh, dict(specs), {}

    def spec(self, name: str):
        return self.specs.get(name.rsplit("/", 1)[-1])

    def shard(self, name: str, full: torch.Tensor) -> torch.Tensor:
        spec = self.spec(name)
        self.shapes[name.rsplit("/", 1)[-1]] = tuple(full.shape)
        return full if spec is None else shard_leaf(full, spec, self.mesh)

    def gather(self, name: str, block: torch.Tensor) -> torch.Tensor:
        key = name.rsplit("/", 1)[-1]
        spec = self.spec(name)
        if spec is None or not any(spec_axes(e) for e in spec):
            return block
        return gather_leaf(block, spec, self.mesh, self.shapes[key])


def param_shardings(mesh, rules: ShardingRules, param_specs: dict
                    ) -> Shardings:
    """The specs of ``param_specs`` (name → spec) on ``mesh``."""
    return Shardings(mesh, param_specs)


def shard_model(model, rules: ShardingRules) -> Shardings:
    """Cut every parameter of ``model`` (full, the same on every rank) to
    this rank's block, in place, by ``models.model.param_specs`` → its
    ``Shardings``."""
    from repro_torch.models.model import param_specs
    sh = param_shardings(rules.mesh, rules, param_specs(model.cfg, rules))
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.data = sh.shard(name, p.data)
    return sh


def gather_params(model, sh: Shardings) -> dict:
    """{name: the full parameter}, on every rank (collective)."""
    return {name: sh.gather(name, p.detach())
            for name, p in model.named_parameters()}


def batch_rows(batch: dict, rules: ShardingRules, axes=None) -> dict:
    """This rank's contiguous rows of each tensor of a global ``batch``
    (dim 0 cut evenly over ``axes``, the rules' batch axes by default: the
    split of ``P(batch)``)."""
    mesh = rules.mesh
    axes = tuple(a for a in (rules.batch if axes is None else axes)
                 if a in mesh.axis_names)
    n, i = mesh.axis_size(axes), mesh.index(axes)
    out = {}
    for k, v in batch.items():
        b = v.shape[0] // n
        if b * n != v.shape[0]:
            raise ValueError(f"batch {k}: {v.shape[0]} rows over {n} ranks")
        out[k] = v[i * b:(i + 1) * b]
    return out


# -- gradients ------------------------------------------------------------------

def _reduce_axes(rules: ShardingRules, spec) -> tuple:
    """The batch axes a gradient is summed over: those its leaf is not cut
    along."""
    cut = {a for e in spec for a in spec_axes(e)}
    return tuple(a for a in rules.batch if a in rules.mesh.axis_names
                 and a not in cut)


def reduce_grads(grads: dict, specs: dict, rules: ShardingRules) -> dict:
    """Each rank's gradients summed over the batch axes (the loss is the
    global mean, so each rank's are its rows' share), in float32, one
    all-reduce of a flat buffer per group; a leaf with no other rank to
    sum with is left as it is. A leaf cut along a batch axis (an expert
    under EP with the model axis in the batch) is summed over the others
    only."""
    mesh = rules.mesh
    buckets: dict = {}
    for name, g in grads.items():
        axes = _reduce_axes(rules, specs[name])
        if axes and mesh.axis_size(axes) > 1:
            buckets.setdefault(axes, []).append(name)
    out = dict(grads)
    for axes, names in buckets.items():
        flat = torch.cat([out[k].float().reshape(-1) for k in names])
        comm.record("all-reduce", flat.numel() * 4, mesh.group(axes))
        dist.all_reduce(flat, group=mesh.group(axes))
        at = 0
        for k in names:
            n = out[k].numel()
            out[k] = flat[at:at + n].view(out[k].shape)
            at += n
    return out


def leaf_max(specs: dict, mesh):
    """→ amax(name, m): the max of the blocks' maxes ``m`` over the axes
    that cut leaf ``name`` (``collectives.compress_grads``'s)."""
    def amax(name, m):
        axes = tuple(a for e in specs[name] for a in spec_axes(e))
        if not axes:
            return m
        m = m.clone()
        comm.record("all-reduce", m.numel() * m.element_size(),
                    mesh.group(axes))
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=mesh.group(axes))
        return m
    return amax


def global_norm(tree: dict, specs: dict, mesh) -> torch.Tensor:
    """√(Σ x²) over the logical leaves: a cut leaf's blocks summed over the
    axes that cut it, each element once."""
    by_axes: dict = {}
    for name, x in tree.items():
        axes = tuple(a for e in specs[name] for a in spec_axes(e))
        sq = x.float().pow(2).sum()
        by_axes[axes] = by_axes.get(axes, 0) + sq
    total = 0
    for axes, sq in by_axes.items():
        if axes:
            sq = sq.clone()
            comm.record("all-reduce", 4, mesh.group(axes))
            dist.all_reduce(sq, group=mesh.group(axes))
        total = total + sq
    return torch.sqrt(total)
