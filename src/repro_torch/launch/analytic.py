"""Analytic per-cell cost model: HBM bytes a device moves a step and the
bytes it holds at its peak.

A copy of the JAX package's ``launch/analytic.py``, equal to it for every
input (``tests/test_torch_dryrun.py``). It counts from ``ArchConfig`` and
the mesh's shape alone, in bf16 weights and activations and float32
optimizer state, so nothing in it belongs to one kind of device: the dry
run (``launch/dryrun.py``) compares its peak with the H100's 80 GB and its
bytes with the H100's HBM rate. Constants are deliberately simple and
stated inline — the napkin-math layer of the roofline.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig, ShapeCell

BF16 = 2
F32 = 4


def _shards(cfg: ArchConfig, mesh_shape: dict) -> tuple[int, int]:
    """(dp, tp) shard counts."""
    tp = mesh_shape.get("model", 1)
    dp = mesh_shape.get("data", 1) * mesh_shape.get("pod", 1)
    return dp, tp


def _param_bytes_dev(cfg: ArchConfig, tp: int) -> float:
    """bf16 param bytes per device. Attention params replicate when heads
    don't divide tp (configs/*.py notes)."""
    P = cfg.param_count()
    if cfg.n_heads and cfg.n_heads % tp != 0:
        attn = cfg.n_layers * (cfg.d_model * (cfg.n_heads + 2 * cfg.n_kv_heads)
                               * cfg.hd + cfg.n_heads * cfg.hd * cfg.d_model)
        return ((P - attn) / tp + attn) * BF16
    return P / tp * BF16


def analytic_cell(cfg: ArchConfig, cell: ShapeCell, mesh_shape: dict,
                  *, remat: bool = True, zero_opt: bool = True,
                  fsdp: bool = False, seq_shard: bool = False,
                  accum: int = 1, strategy: str = "tp") -> dict:
    """→ dict(bytes=HBM traffic/device/step, peak=resident bytes/device)."""
    dp, tp = _shards(cfg, mesh_shape)
    if strategy == "fsdp_dp":
        dp, tp, fsdp = dp * tp, 1, True
    B = cell.global_batch
    S = cell.seq_len // 2 if cfg.enc_layers else cell.seq_len
    B_loc = max(B // dp, 1)
    D, L = cfg.d_model, cfg.n_layers
    Vloc = cfg.vocab_padded // tp
    pdev = _param_bytes_dev(cfg, tp)
    n_attn = sum(1 for i in range(L)
                 if cfg.layer_pattern()[i % len(cfg.layer_pattern())] == "attn")
    H_loc = max(cfg.n_heads // tp, 1) if cfg.n_heads else 0

    if cell.kind == "train":
        tok_loc = B_loc * S
        if fsdp:
            pdev = pdev / dp
        # params: fwd read + remat re-read + dgrad + wgrad passes, once per
        # accumulation microbatch (FSDP re-materializes per layer each pass)
        param_traffic = (4 if remat else 3) * _param_bytes_dev(cfg, tp) * accum
        # optimizer: read grad+mu+nu+master, write mu+nu+master+param
        opt_shards = tp * (dp if zero_opt else 1)
        opt_traffic = 8 * (cfg.param_count() / opt_shards) * F32
        # activations: ~c tensor r/w per layer of the residual-sized stream
        # (qkv/o/mlp in+out, norms, residual adds; MoE dispatch doubles it)
        c = 30 if cfg.moe is not None else 20
        act = L * tok_loc * D * BF16 * c
        # attention score traffic (flash-chunked: scores never hit HBM when
        # S ≤ chunk; above that, ~2 r/w of the running blocks)
        attn_scores = n_attn * B_loc * H_loc * S * min(S, 2048) * BF16 * 2
        logits = 3 * tok_loc * Vloc * F32 * 2            # fwd+bwd, lse etc.
        traffic = param_traffic + opt_traffic + act + attn_scores + logits
        # resident: params + opt(3×f32, ZeRO over DP) + grads + residual
        # stack (seq-sharded under SP) + logits workspace
        tok_mb = tok_loc / accum          # per-microbatch activation terms
        stack = (L * tok_mb * D * BF16 if remat
                 else 3 * L * tok_mb * D * BF16)
        if seq_shard:
            stack /= tp
        # with accumulation the grad accumulator is always resident
        grads = cfg.param_count() / tp / (dp if fsdp else 1) * BF16 \
            * (2 if accum > 1 else 1)
        peak = (pdev + 3 * cfg.param_count() / opt_shards * F32
                + grads + stack + 2 * tok_mb * Vloc * F32
                + 6 * tok_mb * D * BF16)
    elif cell.kind == "prefill":
        tok_loc = B_loc * S
        c = 18 if cfg.moe is not None else 12
        act = L * tok_loc * D * BF16 * c
        attn_scores = n_attn * B_loc * H_loc * S * min(S, 2048) * BF16 * 2
        kv = n_attn * B_loc * S * cfg.n_kv_heads * cfg.hd * BF16 * 2
        # cache resident set: sharded over kv-heads when divisible, else
        # seq-sharded once the stack exceeds 8 GiB (models/layers.py rule)
        if cfg.n_kv_heads and cfg.n_kv_heads % tp == 0:
            kv_res = kv / tp
        elif kv > 8 * 2 ** 30:
            kv_res = kv / tp
        else:
            kv_res = kv
        traffic = pdev * accum + act + attn_scores + kv
        # chunked prefill (accum chunks) divides the activation live-set
        tok_mb = tok_loc / accum
        peak = pdev + kv_res + 8 * tok_mb * D * BF16 + tok_mb * Vloc * BF16
    else:  # decode: one token — read all params + the KV/SSM state
        kv_dev = n_attn * B * S * cfg.n_kv_heads * cfg.hd * BF16 * 2 / (
            dp * tp if B % dp == 0 else tp)
        ssm_dev = 0.0
        if cfg.ssm is not None:
            di = cfg.ssm.expand * D
            Hs = di // cfg.ssm.head_dim
            n_ssm = L - n_attn
            ssm_dev = (n_ssm * B * Hs * cfg.ssm.d_state * cfg.ssm.head_dim
                       * BF16 / max(dp if B % dp == 0 else 1, 1) / 1)
            ssm_dev /= tp if Hs % tp == 0 else 1
        traffic = pdev + kv_dev + 2 * ssm_dev
        peak = pdev + kv_dev + ssm_dev + B_loc * Vloc * F32
    return {"bytes": float(traffic), "peak": float(peak)}
