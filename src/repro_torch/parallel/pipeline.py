"""GPipe-style pipeline parallelism over the "pod" axis: the JAX package's
``parallel/pipeline.py``.

The decoder layers are split into ``pod``-many stages of consecutive
layers; microbatches stream through the stages with ``comm.ppermute``
handoffs. Inside a stage the layers run the TP/DP forward of
``models/model.py`` over the data and model axes, so PP composes with the
rest of the mesh.

Schedule: plain GPipe fill-drain — T = M + S − 1 ticks; at tick t, stage s
computes microbatch t − s (bubble ticks compute on stand-in inputs whose
outputs are masked out, so their gradient is exactly zero). Every rank runs
every tick's handoff and stage, so all ranks build autograd graphs of one
shape and the backward's handoffs (the inverse permutation) pair up: the
reverse pipeline, as ``jax.grad`` of the JAX package's scan gives it.
"""
from __future__ import annotations

import torch

from repro_torch.parallel import comm
from repro_torch.parallel.sharding import batch_rows, current_rules


def pipeline_scan(mesh, stage_fn, n_microbatches: int):
    """Build pp(x_mb) → y_mb: x_mb [M, ...] microbatched activations, the
    same on every stage; ``stage_fn(x)`` applies THIS stage's layers. The
    result, the last stage's outputs summed over "pod" with the mask, is
    the same on every stage."""
    group = mesh.group("pod")
    n_stages = mesh.shape["pod"]
    stage = mesh.axis_index("pod")
    M = n_microbatches
    fwd = [(s, s + 1) for s in range(n_stages - 1)]
    first = torch.tensor(stage == 0)

    def pp(x_mb):
        prev = torch.zeros_like(x_mb[0])
        ys = []
        for t in range(M + n_stages - 1):
            # hand the previous tick's output to the next stage
            recv = comm.ppermute(prev, group, fwd)
            x0 = x_mb[min(max(t - stage, 0), M - 1)]
            prev = stage_fn(torch.where(first, x0, recv))
            ys.append(prev)
        # microbatch m leaves the LAST stage at tick m + S − 1
        out = torch.stack(ys[n_stages - 1:n_stages - 1 + M])
        mask = float(stage == n_stages - 1)
        return comm.psum(out * mask, group)

    return pp


def pipeline_forward(model, batch: dict, mesh, *, n_microbatches: int = 4,
                     remat: str = "none"):
    """Pipeline-parallel forward → logits (dense homogeneous stacks).

    ``batch["tokens"]`` [B, S] is the global batch, the same on every rank;
    each rank takes its contiguous rows over "data" (B / data of them, cut
    into ``n_microbatches``). The embedding and the LM head run on every
    stage outside the pipeline, sharded as the rules in force say; stage s
    runs layers [s·L/S, (s+1)·L/S). The embedding enters the pipeline by
    ``copy_to`` over "pod" (only stage 0 reads it, so its gradient is
    summed there). → this rank's rows of the logits [B / data, S,
    V / model] (its vocabulary block under TP). ``remat="full"``
    recomputes each stage in the backward pass."""
    from repro_torch.models import layers as L
    from repro_torch.models import model as MD
    from torch.utils.checkpoint import checkpoint
    cfg = model.cfg
    if cfg.moe is not None or cfg.enc_layers:
        raise ValueError("pipeline_forward targets homogeneous dense stacks")
    n_stages = mesh.shape["pod"]
    n_layers = len(model.layers)
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers over {n_stages} stages")
    r = current_rules()
    rows = batch_rows({"tokens": batch["tokens"]}, r, axes=("data",))
    tokens = rows["tokens"]
    B, S = tokens.shape
    M = n_microbatches
    if B % M:
        raise ValueError(f"{B} rows into {M} microbatches")
    par = MD._Par(r, S, seq=False)
    x, _ = MD._embed(model, {"tokens": tokens}, True, par)
    x = comm.copy_to(x, mesh.group("pod"))
    rope = L.rope_for(torch.arange(S, device=model.device), cfg)
    per = n_layers // n_stages
    stage = mesh.axis_index("pod")
    layers = list(model.layers)[stage * per:(stage + 1) * per]

    def stage_fn(x):
        for layer in layers:
            x, _ = MD._apply_sublayer(layer, x, cfg, rope, train=True,
                                      par=par)
        return x

    fn = stage_fn
    if remat != "none":
        fn = lambda x: checkpoint(stage_fn, x, use_reentrant=False)
    y_mb = pipeline_scan(mesh, fn, M)(x.reshape(M, B // M, *x.shape[1:]))
    return MD._head(model, y_mb.reshape(B, *y_mb.shape[2:]), par)
