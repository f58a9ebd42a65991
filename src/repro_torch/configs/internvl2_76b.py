"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 (LLM backbone only; InternViT frontend is a STUB providing
patch embeddings). SwiGLU, RMSNorm, RoPE. [arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="internvl2-76b", family="dense", n_layers=80, d_model=8192,
        n_heads=64, n_kv_heads=8, d_ff=28672, vocab=128256,
        activation="swiglu", norm="rmsnorm", modality="vlm",
        notes="Largest assigned arch (~76B params); patch embeddings occupy "
              "the first 256 positions of each sequence."),
    smoke=ArchConfig(
        name="internvl2-76b-smoke", family="dense", n_layers=2, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
        activation="swiglu", norm="rmsnorm", modality="vlm"),
)
