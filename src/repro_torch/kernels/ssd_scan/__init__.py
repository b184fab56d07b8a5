from .ops import ssd, ssd_decode_step
from .ref import ssd_chunked_ref, ssd_ref, ssd_scan_ref

__all__ = ["ssd", "ssd_decode_step", "ssd_chunked_ref", "ssd_ref",
           "ssd_scan_ref"]
