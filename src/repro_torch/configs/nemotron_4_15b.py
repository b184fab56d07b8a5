"""nemotron-4-15b [dense]: 32L d6144 48H (GQA kv=8) ff24576 vocab=256000.
GQA + squared-ReLU MLP + partial rotary (arXiv:2402.16819).

The numbers are ``repro.configs.nemotron_4_15b``'s."""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-15b",
        family="dense",
        n_layers=32,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=24576,
        vocab=256000,
        act="relu2",
        gated_mlp=False,
        partial_rotary=0.5,
        rope_theta=10000.0,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="nemotron-4-15b-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=512,
        act="relu2",
        gated_mlp=False,
        partial_rotary=0.5,
    )
