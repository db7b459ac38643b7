# Verbatim copy of repro/configs/qwen2_0_5b.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [arXiv:2407.10671; hf]
    name="qwen2-0.5b", family="dense",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, d_ff=4864,
    vocab=151936, qkv_bias=True, tie_embeddings=True, rope_theta=1e6,
)
