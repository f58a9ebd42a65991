"""Roofline terms of a dry-run cell from what the port counts.

The JAX package's ``launch/roofline.py`` parses the FLOPs, HBM bytes and
collective bytes out of XLA's compiled HLO. The port has no compiled
program to parse, so ``count_step`` counts while it runs a cell's step on
``meta`` tensors:

* FLOPs — ``torch.utils.flop_counter.FlopCounterMode``: the matrix
  products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, an ``einsum`` through
  them, SDPA), plus the hand-written kernels' FLOPs, which the counter
  does not see: the flash kernel's 4·B·H·Sq·Sk·hd a call
  (``kernels/flash_attention/ops.py:meta_flops``), the grid kernels' 11 a
  pair (``kernels/grid_force/ops.py:meta_flops``). ``count_step`` misses
  the elementwise work (norms, RoPE, activations, the plain attention's
  softmax, the SSD's decays and cumulative sums, the MoE's dispatch),
  which the HLO count takes in at one FLOP an element: the ``lm`` suite's
  count is the matrix products' alone. ``count_ops`` (the ``layout`` and
  ``pp`` suites) adds that work, from ``launch/opcount.py:OpCounter``;
* collective bytes — ``parallel/comm.py:counting``, by kind and group
  size, at the JAX package's ring-model bytes a rank;
* HBM bytes — ``launch/analytic.py:analytic_cell`` (the ``lm`` suite
  passes them in), or ``OpCounter``'s unfused sum of every op's inputs
  and outputs (``count_ops``), the kernels' own reads and writes added;
* peak live bytes (``count_ops``) — ``OpCounter``'s high-water mark of
  the live storages.

``roofline_terms`` and ``summarize_collectives`` are the JAX package's,
against the NVIDIA H100 data-sheet rates of ``launch/mesh.py``: the
collective term at one direction of NVLink, the rate between the cards of
one host (a collective across hosts is slower; not modelled).
"""
from __future__ import annotations

import contextlib
import dataclasses

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    #: (kind, bytes a rank moves, group size)
    coll_detail: list = dataclasses.field(default_factory=list)
    #: the FLOPs by where they were counted: ``matmul`` (FlopCounterMode),
    #: ``kernels`` (the kernels' meta routes), ``elementwise`` (OpCounter)
    flops_by: dict = dataclasses.field(default_factory=dict)
    #: the high-water mark of the live bytes (``count_ops``)
    peak_bytes: float = 0.0


@contextlib.contextmanager
def _collecting(name: str, *modules):
    """Within ``with``: each module's list ``name`` (``meta_flops``,
    ``meta_bytes``) a fresh one; yields them."""
    prev = [getattr(m, name) for m in modules]
    got = [[] for _ in modules]
    for m, lst in zip(modules, got):
        setattr(m, name, lst)
    try:
        yield got
    finally:
        for m, v in zip(modules, prev):
            setattr(m, name, v)


def count_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` counting → (its result, a ``Cost`` of
    its FLOPs and collective bytes; ``bytes`` 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.kernels.grid_force import ops as grid_ops
    from repro_torch.parallel import comm
    with _collecting("meta_flops", flash_ops, grid_ops) as got:
        with FlopCounterMode(display=False) as fc, comm.counting() as coll:
            out = fn(*args, **kwargs)
        kernels = sum(sum(v) for v in got)
    detail = [(kind, b, g) for (kind, g), b in coll.items()]
    mm = fc.get_total_flops()
    return out, Cost(flops=float(mm + kernels),
                     coll_bytes=float(sum(coll.values())),
                     coll_detail=detail,
                     flops_by=dict(matmul=float(mm), kernels=float(kernels)))


def count_ops(fn, *args, live=(), **kwargs):
    """``count_step`` under ``launch/opcount.py:OpCounter`` → (the
    result, a ``Cost`` whose FLOPs add the elementwise work, whose
    ``bytes`` are the ops' unfused HBM bytes plus the kernels' own, and
    whose ``peak_bytes`` is the high-water mark of the live storages,
    ``live`` (the step's inputs) among them from the start)."""
    from repro_torch.kernels.grid_force import ops as grid_ops
    from repro_torch.launch.opcount import OpCounter
    with _collecting("meta_bytes", grid_ops) as got:
        with OpCounter(live) as oc:
            out, cost = count_step(fn, *args, **kwargs)
        kernel_bytes = sum(sum(v) for v in got)
    cost.flops += oc.flops
    cost.flops_by["elementwise"] = float(oc.flops)
    cost.bytes = float(oc.bytes + kernel_bytes)
    cost.peak_bytes = float(oc.peak_bytes)
    return out, cost


def roofline_terms(cost: Cost, *, model_flops_per_device: float = 0.0):
    compute_s = cost.flops / PEAK_FLOPS_BF16
    memory_s = cost.bytes / HBM_BW
    coll_s = cost.coll_bytes / NVLINK_BW
    dom = max((compute_s, "compute"), (memory_s, "memory"),
              (coll_s, "collective"))
    total = max(compute_s, memory_s, coll_s)
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": coll_s,
        "bottleneck": dom[1],
        "flops": cost.flops,
        "bytes": cost.bytes,
        "coll_bytes": cost.coll_bytes,
        "model_flops": model_flops_per_device,
        "useful_ratio": (model_flops_per_device / cost.flops
                         if cost.flops else 0.0),
        "roofline_frac": (model_flops_per_device / PEAK_FLOPS_BF16 / total
                          if total > 0 else 0.0),
    }


def summarize_collectives(cost: Cost, top: int = 6):
    agg: dict = {}
    for (name, b, g) in cost.coll_detail:
        agg[(name, g)] = agg.get((name, g), 0.0) + b
    rows = sorted(agg.items(), key=lambda kv: -kv[1])[:top]
    return [{"op": k[0], "group": k[1], "bytes": v} for k, v in rows]
