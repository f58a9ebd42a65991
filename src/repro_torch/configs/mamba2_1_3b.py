"""mamba2-1.3b [ssm] — 48L d_model=2048, attention-free SSD (state-space
duality), ssm_state=128, vocab=50280. Sub-quadratic: runs long_500k.
[arXiv:2405.21060; unverified]"""
from repro_torch.configs.base import ArchConfig, SSMConfig, register

CONFIG = register(
    ArchConfig(
        name="mamba2-1.3b", family="ssm", n_layers=48, d_model=2048,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=50280,
        norm="rmsnorm", tie_embeddings=True,
        ssm=SSMConfig(d_state=128, expand=2, head_dim=64, n_groups=1,
                      chunk=256),
        subquadratic=True,
        notes="vocab padded 50280→50288; SSD inner dim 4096 → 64 SSD heads, "
              "TP-sharded over model=16 (4/device); O(1)-state decode."),
    smoke=ArchConfig(
        name="mamba2-1.3b-smoke", family="ssm", n_layers=2, d_model=64,
        n_heads=0, n_kv_heads=0, d_ff=0, vocab=512, norm="rmsnorm",
        tie_embeddings=True,
        ssm=SSMConfig(d_state=16, expand=2, head_dim=16, n_groups=1, chunk=32),
        subquadratic=True),
)
