"""Serving front-end of the port: the batched LM generation engine."""
from .engine import Engine, Request, prefill_to_decode_cache

__all__ = ["Engine", "Request", "prefill_to_decode_cache"]
