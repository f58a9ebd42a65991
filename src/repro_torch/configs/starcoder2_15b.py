"""starcoder2-15b [dense] — 40L d_model=6144 48H (GQA kv=4) d_ff=24576
vocab=49152, GELU MLP, LayerNorm, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="starcoder2-15b", family="dense", n_layers=40, d_model=6144,
        n_heads=48, n_kv_heads=4, d_ff=24576, vocab=49152,
        activation="gelu", norm="layernorm",
        notes="48 q heads TP-sharded over model=16 (3/device); kv=4 "
              "replicated."),
    smoke=ArchConfig(
        name="starcoder2-15b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        activation="gelu", norm="layernorm"),
)
