"""Roofline terms of a dry-run cell from what the port counts.

The JAX package's ``launch/roofline.py`` parses the FLOPs, HBM bytes and
collective bytes out of XLA's compiled HLO. The port has no compiled
program to parse, so ``count_step`` counts while it runs a cell's step on
``meta`` tensors:

* FLOPs — ``torch.utils.flop_counter.FlopCounterMode``: the matrix
  products (``mm``, ``addmm``, ``bmm``, ``baddbmm``, an ``einsum`` through
  them, SDPA), plus the flash kernel's 4·B·H·Sq·Sk·hd a call, which the
  counter does not see (``kernels/flash_attention/ops.py:meta_flops``). It
  misses the elementwise work (norms, RoPE, activations, the plain
  attention's softmax, the SSD's decays and cumulative sums, the MoE's
  dispatch), which the HLO count takes in at one FLOP an element: the
  port's count is the matrix products' alone;
* collective bytes — ``parallel/comm.py:counting``, by kind and group
  size, at the JAX package's ring-model bytes a rank;
* HBM bytes — ``launch/analytic.py:analytic_cell`` (the dry run passes
  them in).

``roofline_terms`` and ``summarize_collectives`` are the JAX package's,
against the NVIDIA H100 data-sheet rates of ``launch/mesh.py``: the
collective term at one direction of NVLink, the rate between the cards of
one host (a collective across hosts is slower; not modelled).
"""
from __future__ import annotations

import dataclasses

from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16


@dataclasses.dataclass
class Cost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    #: (kind, bytes a rank moves, group size)
    coll_detail: list = dataclasses.field(default_factory=list)


def count_step(fn, *args, **kwargs):
    """Run ``fn(*args, **kwargs)`` counting → (its result, a ``Cost`` of
    its FLOPs and collective bytes; ``bytes`` 0)."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash_attention import ops as flash_ops
    from repro_torch.parallel import comm
    prev, flash_ops.meta_flops = flash_ops.meta_flops, []
    try:
        with FlopCounterMode(display=False) as fc, comm.counting() as coll:
            out = fn(*args, **kwargs)
        flash = sum(flash_ops.meta_flops)
    finally:
        flash_ops.meta_flops = prev
    detail = [(kind, b, g) for (kind, g), b in coll.items()]
    return out, Cost(flops=float(fc.get_total_flops() + flash),
                     coll_bytes=float(sum(coll.values())),
                     coll_detail=detail)


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
