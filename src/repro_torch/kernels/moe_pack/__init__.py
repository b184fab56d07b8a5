from .ops import combine, pack
from .ref import combine_rows_ref, gather_rows_ref

__all__ = ["combine", "pack", "combine_rows_ref", "gather_rows_ref"]
