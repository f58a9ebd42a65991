"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (MHA kv=16) d_ff=1408/expert,
vocab=102400, 2 shared + 64 routed top-6 (fine-grained), layer 0 dense FFN
(width 10944). SwiGLU, RMSNorm, RoPE. [arXiv:2401.06066; hf]"""
from repro_torch.configs.base import ArchConfig, MoEConfig, register

CONFIG = register(
    ArchConfig(
        name="deepseek-moe-16b", family="moe", n_layers=28, d_model=2048,
        n_heads=16, n_kv_heads=16, d_ff=1408, vocab=102400,
        activation="swiglu", norm="rmsnorm",
        moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_expert=1408,
                      first_dense_ff=10944),
        notes="64 routed experts EP-sharded over model=16 (4/device); "
              "2 shared experts TP-sharded."),
    smoke=ArchConfig(
        name="deepseek-moe-16b-smoke", family="moe", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=4, d_ff=32, vocab=512,
        activation="swiglu", norm="rmsnorm",
        moe=MoEConfig(n_experts=8, top_k=2, n_shared=1, d_expert=32,
                      first_dense_ff=128, capacity_factor=4.0)),
)
