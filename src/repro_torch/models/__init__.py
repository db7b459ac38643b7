"""The LM stack of the port: dense attention-only decoders (prefill through
the flash-attention kernel, ring-buffer decode)."""
from .model import LM, init_cache, init_lm

__all__ = ["LM", "init_cache", "init_lm"]
