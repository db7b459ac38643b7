# Verbatim copy of repro/configs/mixtral_8x22b.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [arXiv:2401.04088; hf] — 8 experts top-2, SWA per assignment.
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=32768, head_dim=128, n_experts=8, top_k=2, moe_d_ff=16384,
    window=4096, sub_quadratic=True, rope_theta=1e6,
    notes="SWA window 4096 → long_500k decode runs with bounded cache",
)
