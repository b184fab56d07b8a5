from .ops import combine, combine_lanes, pack
from .ref import combine_lanes_ref, combine_rows_ref, gather_rows_ref

__all__ = ["combine", "combine_lanes", "pack", "combine_lanes_ref",
           "combine_rows_ref", "gather_rows_ref"]
