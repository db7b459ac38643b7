"""The LM stack of the port: decoders of attention blocks (prefill through
the flash-attention kernel, ring-buffer decode), recurrent blocks (mLSTM,
sLSTM, RG-LRU) and dense or MoE FFNs."""
from .model import LM, init_cache, init_lm

__all__ = ["LM", "init_cache", "init_lm"]
