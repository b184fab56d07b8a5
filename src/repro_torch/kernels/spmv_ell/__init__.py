from .ops import (
    DEFAULT_BLOCK_COLS,
    DEFAULT_BLOCK_ROWS,
    csr_to_ell,
    from_bucket_major,
    spmv,
    spmv_blocked,
    spmv_blocked_partial,
    spmv_blocked_skip,
    to_bucket_major,
)
from .ref import (
    spmv_ell_blocked_partial_ref,
    spmv_ell_blocked_ref,
    spmv_ell_blocked_skip_ref,
    spmv_ell_ref,
)

__all__ = [
    "csr_to_ell", "spmv", "spmv_blocked",
    "spmv_blocked_partial", "spmv_blocked_skip",
    "to_bucket_major", "from_bucket_major",
    "spmv_ell_ref", "spmv_ell_blocked_ref", "spmv_ell_blocked_partial_ref",
    "spmv_ell_blocked_skip_ref", "DEFAULT_BLOCK_COLS", "DEFAULT_BLOCK_ROWS",
]
