"""jamba-v0.1-52b [hybrid] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336,
vocab=65536, Mamba+attention 1:7 interleave, MoE 16e top-2 every other
layer. SwiGLU, RMSNorm. Sub-quadratic (mostly SSM): runs long_500k.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import (ArchConfig, MoEConfig, SSMConfig,
                                      register)

# period-8 block: attention at position 4 (1:7 attn:mamba), MoE on odd layers
_PATTERN = ("ssm", "ssm", "ssm", "ssm", "attn", "ssm", "ssm", "ssm")

CONFIG = register(
    ArchConfig(
        name="jamba-v0.1-52b", family="hybrid", n_layers=32, d_model=4096,
        n_heads=32, n_kv_heads=8, d_ff=14336, vocab=65536,
        activation="swiglu", norm="rmsnorm", pattern=_PATTERN,
        moe=MoEConfig(n_experts=16, top_k=2, n_shared=0, d_expert=14336,
                      every=2),
        ssm=SSMConfig(d_state=16, expand=2, head_dim=64, n_groups=1,
                      chunk=256),
        subquadratic=True,
        notes="Stack scans 4 period-8 blocks; 16 experts EP-sharded "
              "(1/device); only 4 attention layers hold KV caches, so "
              "long_500k decode is dominated by SSM state updates."),
    smoke=ArchConfig(
        name="jamba-v0.1-52b-smoke", family="hybrid", n_layers=4, d_model=64,
        n_heads=4, n_kv_heads=2, d_ff=64, vocab=512,
        activation="swiglu", norm="rmsnorm", pattern=("ssm", "attn"),
        moe=MoEConfig(n_experts=4, top_k=2, n_shared=0, d_expert=64, every=2,
                      capacity_factor=4.0),
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1, chunk=16),
        subquadratic=True),
)
