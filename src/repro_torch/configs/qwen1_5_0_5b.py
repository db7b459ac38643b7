# Verbatim copy of repro/configs/qwen1_5_0_5b.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [hf:Qwen/Qwen1.5-0.5B]
    name="qwen1.5-0.5b", family="dense",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=16, d_ff=2816,
    vocab=151936, qkv_bias=True, tie_embeddings=True,
)
