# Verbatim copy of repro/configs/recurrentgemma_9b.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [arXiv:2402.19427; unverified] — RG-LRU + local attention, 1:2 ratio
    # (pattern: two recurrent blocks, then one local-attention block).
    name="recurrentgemma-9b", family="hybrid",
    n_layers=38, d_model=4096, n_heads=16, n_kv_heads=1, d_ff=12288,
    vocab=256000, window=2048, act="geglu",
    pattern=("rglru", "rglru", "attn"), sub_quadratic=True,
    notes="38 = 12×(rec,rec,attn) + (rec,rec) remainder; local attn window 2048",
)
