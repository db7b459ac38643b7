# Verbatim copy of repro/configs/qwen3_moe_235b_a22b.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [hf:Qwen/Qwen3-30B-A3B family scaled per assignment] — 128e top-8.
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_ff=1536,
    vocab=151936, head_dim=128, n_experts=128, top_k=8, moe_d_ff=1536,
    qk_norm=True, rope_theta=1e6,
    notes="full attention (no long_500k); EP 128/16=8 experts per shard",
)
