"""gemma3-1b [dense]: 26L d1152 4H (MQA kv=1, d_head=256) ff6912
vocab=262144; 5 local(512-window):1 global, qk-norm, sandwich norms,
tied embeddings (hf:google/gemma-3-1b-pt).

The numbers are ``repro.configs.gemma3_1b``'s."""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="gemma3-1b",
        family="dense",
        n_layers=26,
        d_model=1152,
        n_heads=4,
        n_kv_heads=1,
        d_head=256,
        d_ff=6912,
        vocab=262144,
        act="gelu",
        rope_theta=1_000_000.0,
        qk_norm=True,
        sandwich_norm=True,
        tie_embeddings=True,
        window=512,
        local_global_period=6,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="gemma3-1b-smoke",
        family="dense",
        n_layers=6,          # one full 5:1 local:global period
        d_model=64,
        n_heads=4,
        n_kv_heads=1,
        d_head=16,
        d_ff=128,
        vocab=512,
        act="gelu",
        qk_norm=True,
        sandwich_norm=True,
        tie_embeddings=True,
        window=16,
        local_global_period=6,
    )
