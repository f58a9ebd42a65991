"""granite-moe-3b-a800m [moe] — 32L d_model=1536 24H (GQA kv=8) d_ff=512/expert,
vocab=49155, MoE 40e top-8. SwiGLU, RMSNorm, RoPE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]

Note: the structured spec says "MoE 40e top-8"; the prose note says "32
experts top-8". We follow the structured spec (40 experts) — see DESIGN.md.
40 experts do not divide the 16-way model axis, so expert FFNs are
TP-sharded inside each expert instead of EP-sharded (d_expert=512 → 32
cols/device)."""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="granite-moe-3b-a800m", family="moe", n_layers=32, d_model=1536,
        n_heads=24, n_kv_heads=8, d_ff=512, vocab=49155,
        activation="swiglu", norm="rmsnorm",
        moe=MoEConfig(n_experts=40, top_k=8, n_shared=0, d_expert=512),
        notes="vocab padded 49155→49168; 24 q heads not divisible by 16 → "
              "attention replicated in the baseline."),
    smoke=ArchConfig(
        name="granite-moe-3b-a800m-smoke", family="moe", n_layers=2,
        d_model=64, n_heads=4, n_kv_heads=2, d_ff=32, vocab=512,
        activation="swiglu", norm="rmsnorm",
        moe=MoEConfig(n_experts=5, top_k=2, n_shared=0, d_expert=32,
                      capacity_factor=4.0)),
)
