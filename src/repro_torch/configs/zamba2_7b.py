"""zamba2-7b [hybrid]: 81 Mamba2 layers d3584 (d_inner=7168, ssm_state=64,
head_dim=64 -> 112 SSD heads) + 2 alternating shared attention blocks
(32H over concat(x, x_emb)=2d) applied every 6 SSM layers, ff=14336,
vocab=32000 (arXiv:2411.15242).

The numbers are ``repro.configs.zamba2_7b``'s."""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b",
        family="hybrid",
        n_layers=81,
        d_model=3584,
        n_heads=32,
        n_kv_heads=32,
        d_ff=14336,
        vocab=32000,
        ssm_state=64,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_groups=1,
        d_conv=4,
        shared_attn_period=6,
        n_shared_attn_blocks=2,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="zamba2-7b-smoke",
        family="hybrid",
        n_layers=5,          # 2 segments of 2 + tail 1
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        ssm_groups=1,
        d_conv=4,
        shared_attn_period=2,
        n_shared_attn_blocks=2,
    )
