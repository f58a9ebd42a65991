"""gemma-2b [dense] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000,
GeGLU, head_dim=256, RoPE, tied embeddings. [arXiv:2403.08295; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="gemma-2b", family="dense", n_layers=18, d_model=2048,
        n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384, vocab=256000,
        activation="geglu", norm="rmsnorm", tie_embeddings=True,
        notes="MQA (kv=1): KV projections replicated under TP; q heads (8) "
              "not divisible by model=16 → attention computed replicated "
              "(≈8%% of layer FLOPs), FFN/vocab TP-sharded."),
    smoke=ArchConfig(
        name="gemma-2b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=1, head_dim=16, d_ff=128, vocab=512,
        activation="geglu", norm="rmsnorm", tie_embeddings=True),
)
