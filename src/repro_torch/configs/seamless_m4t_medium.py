"""seamless-m4t-medium [audio] — enc-dec, 12L(+12L enc) d_model=1024 16H
(MHA kv=16) d_ff=4096 vocab=256206. Modality frontend is a STUB: the
encoder consumes precomputed audio-frame embeddings from input_specs().
[arXiv:2308.11596; hf]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(
    ArchConfig(
        name="seamless-m4t-medium", family="encdec", n_layers=12,
        enc_layers=12, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=4096,
        vocab=256206, activation="gelu", norm="layernorm", modality="audio",
        notes="vocab 256206 padded to 256208 for 16-way TP; shape cells "
              "split seq_len as S/2 encoder frames + S/2 decoder tokens."),
    smoke=ArchConfig(
        name="seamless-m4t-medium-smoke", family="encdec", n_layers=2,
        enc_layers=2, d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
        vocab=512, activation="gelu", norm="layernorm", modality="audio"),
)
