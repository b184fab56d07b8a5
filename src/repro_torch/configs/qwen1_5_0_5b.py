"""qwen1.5-0.5b [dense]: 24L d1024 16H (kv=16) ff2816 vocab=151936,
QKV bias, tied embeddings (hf:Qwen/Qwen1.5-0.5B).

The numbers are ``repro.configs.qwen1_5_0_5b``'s."""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        d_ff=2816,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen1.5-0.5b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        tie_embeddings=True,
    )
