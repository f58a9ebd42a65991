"""Architecture + shape configuration system (the port's own copy).

Every assigned architecture is an ``ArchConfig``; the per-arch files in this
package instantiate the exact published configs and a reduced smoke config
of the same family. Input-shape cells (train_4k / prefill_32k / decode_32k /
long_500k) are defined here once and paired with every arch. Pure Python,
kept field for field equal to the JAX package's ``configs/base.py`` so a
config means the same model in both packages.
"""
from __future__ import annotations

import dataclasses


def pad_to(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    n_shared: int = 0            # shared (always-on) experts
    d_expert: int = 0            # per-expert FFN hidden size
    capacity_factor: float = 1.25
    every: int = 1               # MoE every `every`-th layer (jamba: 2)
    first_dense_ff: int = 0      # deepseek: layer 0 dense FFN width


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    chunk: int = 256             # SSD chunk length
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | encdec | ssm | moe | hybrid
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 → d_model // n_heads
    activation: str = "swiglu"   # swiglu | geglu | gelu
    norm: str = "rmsnorm"        # rmsnorm | layernorm
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    # hybrid: layer pattern within one period, scanned n_layers/len(pattern)
    # times; entries: "attn" | "ssm". Empty → all "attn" (or all "ssm").
    pattern: tuple = ()
    subquadratic: bool = False   # supports long_500k decode
    modality: str = "text"       # text | audio | vlm — non-text get stub frontends
    enc_layers: int = 0          # encdec only
    notes: str = ""

    @property
    def hd(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def vocab_padded(self) -> int:
        """Vocab padded to a multiple of 16 for TP sharding."""
        return pad_to(self.vocab, 16)

    def layer_pattern(self) -> tuple:
        if self.pattern:
            return self.pattern
        return ("ssm",) if self.family == "ssm" else ("attn",)

    @property
    def n_layer_groups(self) -> int:
        return self.n_layers // len(self.layer_pattern())

    def param_count(self) -> int:
        """Analytic parameter count (embedding + stack), used for 6·N·D."""
        D, hd = self.d_model, self.hd
        emb = self.vocab_padded * D * (1 if self.tie_embeddings else 2)
        per_attn = D * self.n_heads * hd + 2 * D * self.n_kv_heads * hd \
            + self.n_heads * hd * D
        gated = self.activation in ("swiglu", "geglu")
        def ffn(width): return D * width * (3 if gated else 2)
        per_ssm = 0
        if self.ssm is not None:
            di = self.ssm.expand * D
            nh = di // self.ssm.head_dim
            gn = self.ssm.n_groups * self.ssm.d_state
            per_ssm = D * (2 * di + 2 * gn + nh) + di * D + 2 * nh \
                + self.ssm.conv_width * (di + 2 * gn)
        total = emb
        pat = self.layer_pattern()
        for li in range(self.n_layers):
            kind = pat[li % len(pat)]
            total += per_attn if kind == "attn" else per_ssm
            # FFN / MoE part
            if self.moe is not None:
                if li == 0 and self.moe.first_dense_ff:
                    total += ffn(self.moe.first_dense_ff)
                elif (li % self.moe.every) == self.moe.every - 1:
                    total += self.moe.n_experts * ffn(self.moe.d_expert) \
                        + self.moe.n_shared * ffn(self.moe.d_expert) \
                        + D * self.moe.n_experts  # router
                elif self.d_ff:
                    total += ffn(self.d_ff)
            elif self.d_ff:
                total += ffn(self.d_ff)
            total += 2 * D  # norms
        if self.enc_layers:  # encoder stack + cross-attention
            total += self.enc_layers * (per_attn + ffn(self.d_ff) + 2 * D)
            total += self.n_layers * (per_attn + D)  # cross-attn in decoder
        return total

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only routed top-k + shared)."""
        if self.moe is None:
            return self.param_count()
        full = self.param_count()
        gated = self.activation in ("swiglu", "geglu")
        D = self.d_model
        def ffn(width): return D * width * (3 if gated else 2)
        n_moe_layers = sum(
            1 for li in range(self.n_layers)
            if (li % self.moe.every) == self.moe.every - 1
            and not (li == 0 and self.moe.first_dense_ff))
        inactive = n_moe_layers * (self.moe.n_experts - self.moe.top_k) \
            * ffn(self.moe.d_expert)
        return full - inactive


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    seq_len: int
    global_batch: int
    kind: str                    # train | prefill | decode


SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


def cells_for(cfg: ArchConfig) -> list[ShapeCell]:
    """The runnable shape cells for an arch (long_500k needs sub-quadratic
    attention — skipped for pure full-attention archs, per assignment)."""
    out = [SHAPES["train_4k"], SHAPES["prefill_32k"], SHAPES["decode_32k"]]
    if cfg.subquadratic:
        out.append(SHAPES["long_500k"])
    return out


_REGISTRY: dict[str, "ArchConfig"] = {}
_SMOKE: dict[str, "ArchConfig"] = {}


def register(cfg: ArchConfig, smoke: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    _SMOKE[cfg.name] = smoke
    return cfg


def get_config(name: str) -> ArchConfig:
    from repro_torch import configs as _  # ensure per-arch modules imported
    return _REGISTRY[name]


def get_smoke_config(name: str) -> ArchConfig:
    from repro_torch import configs as _
    return _SMOKE[name]


def list_archs() -> list[str]:
    from repro_torch import configs as _
    return sorted(_REGISTRY)
