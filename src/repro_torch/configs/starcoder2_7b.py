"""starcoder2-7b [dense] — 32L d_model=4608 36H (GQA kv=4) d_ff=18432
vocab=49152, GELU MLP, LayerNorm, RoPE. [arXiv:2402.19173; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="starcoder2-7b", family="dense", n_layers=32, d_model=4608,
        n_heads=36, n_kv_heads=4, d_ff=18432, vocab=49152,
        activation="gelu", norm="layernorm",
        notes="36 q heads not divisible by model=16 → attention replicated "
              "in the baseline (≈22%% of layer FLOPs); §Perf hillclimbs this."),
    smoke=ArchConfig(
        name="starcoder2-7b-smoke", family="dense", n_layers=2, d_model=72,
        n_heads=6, n_kv_heads=2, d_ff=144, vocab=512,
        activation="gelu", norm="layernorm"),
)
