# Verbatim copy of repro/configs/qwen3_1_7b.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [hf:Qwen/Qwen3-8B family] — qk_norm, GQA.
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_ff=6144,
    vocab=151936, head_dim=128, qk_norm=True, tie_embeddings=True,
    rope_theta=1e6,
)
