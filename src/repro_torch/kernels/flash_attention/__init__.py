from .ops import attention, flash_attention_bh
from .ref import attention_ref, flash_attention_bh_ref

__all__ = ["attention", "attention_ref", "flash_attention_bh",
           "flash_attention_bh_ref"]
