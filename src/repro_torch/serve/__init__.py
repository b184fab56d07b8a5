"""Serving engine of the port (``repro.serve`` counterpart)."""
from .engine import Request, ServeEngine

__all__ = ["Request", "ServeEngine"]
