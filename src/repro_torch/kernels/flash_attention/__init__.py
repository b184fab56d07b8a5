from .ops import (FlashAttentionBH, attention, flash_attention_bh,
                  flash_attention_bh_bwd)
from .ref import (attention_ref, flash_attention_bh_bwd_ref,
                  flash_attention_bh_ref)

__all__ = ["FlashAttentionBH", "attention", "attention_ref",
           "flash_attention_bh", "flash_attention_bh_bwd",
           "flash_attention_bh_bwd_ref",
           "flash_attention_bh_ref"]
