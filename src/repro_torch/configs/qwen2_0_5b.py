"""qwen2-0.5b [dense]: 24L d896 14H (GQA kv=2) ff4864 vocab=151936,
QKV bias, tied embeddings (arXiv:2407.10671).

The numbers are ``repro.configs.qwen2_0_5b``'s."""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-0.5b",
        family="dense",
        n_layers=24,
        d_model=896,
        n_heads=14,
        n_kv_heads=2,
        d_ff=4864,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-0.5b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        tie_embeddings=True,
    )
