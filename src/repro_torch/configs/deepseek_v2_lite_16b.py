"""deepseek-v2-lite-16b [moe]: 27L d2048 16H, MLA kv_lora=512
(nope=128, rope=64, v=128), MoE 64 routed top-6 + 2 shared (expert
ff=1408), first layer dense (ff=10944), vocab=102400 (arXiv:2405.04434).

The numbers are ``repro.configs.deepseek_v2_lite_16b``'s."""
from ..models.common import ArchConfig


def config() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b",
        family="moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=10944,            # the single leading dense layer
        d_ff_expert=1408,
        vocab=102400,
        n_experts=64,
        n_shared_experts=2,
        top_k=6,
        first_dense_layers=1,
        mla=True,
        kv_lora=512,
        qk_nope_dim=128,
        qk_rope_dim=64,
        v_head_dim=128,
    )


def reduced() -> ArchConfig:
    return ArchConfig(
        name="deepseek-v2-lite-16b-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        n_heads=4,
        n_kv_heads=4,
        d_ff=160,
        d_ff_expert=32,
        vocab=512,
        n_experts=8,
        n_shared_experts=2,
        top_k=3,
        first_dense_layers=1,
        mla=True,
        kv_lora=32,
        qk_nope_dim=16,
        qk_rope_dim=8,
        v_head_dim=16,
    )
