"""mamba2-780m [ssm]: 48L d1536, attn-free, vocab=50280, ssm_state=128,
SSD head_dim=64 (arXiv:2405.21060).

The numbers are ``repro.configs.mamba2_780m``'s."""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m",
        family="ssm",
        n_layers=48,
        d_model=1536,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        # 50,280 padded to 50,432 (= 256*197): embedding tables are padded
        # to a TP-friendly multiple, standard practice; pad logits unused
        vocab=50432,
        tie_embeddings=True,
        ssm_state=128,
        ssm_head_dim=64,
        ssm_expand=2,
        ssm_groups=1,
        d_conv=4,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="mamba2-780m-smoke",
        family="ssm",
        n_layers=3,
        d_model=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=512,
        tie_embeddings=True,
        ssm_state=16,
        ssm_head_dim=16,
        ssm_expand=2,
        ssm_groups=1,
        d_conv=4,
    )
