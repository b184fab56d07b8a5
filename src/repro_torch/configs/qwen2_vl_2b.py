"""qwen2-vl-2b [vlm]: 28L d1536 12H (GQA kv=2) ff8960 vocab=151936,
M-RoPE (sections 16/24/24), dynamic-resolution vision frontend = STUB:
input_specs provide precomputed patch embeddings (arXiv:2409.12191).

The numbers are ``repro.configs.qwen2_vl_2b``'s."""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b",
        family="vlm",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        d_ff=8960,
        vocab=151936,
        qkv_bias=True,
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        mrope_sections=(16, 24, 24),
        frontend_stub=True,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="qwen2-vl-2b-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        qkv_bias=True,
        tie_embeddings=True,
        mrope_sections=(2, 3, 3),
        frontend_stub=True,
    )
