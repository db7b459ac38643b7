# Verbatim copy of repro/configs/phi3_vision_4_2b.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [hf:microsoft/Phi-3-vision-128k-instruct] — phi3-mini backbone + CLIP
    # frontend.  CLIP tower is a STUB: input_specs() provides precomputed
    # patch+text embeddings (B, S, d_model).
    name="phi-3-vision-4.2b", family="vlm",
    n_layers=32, d_model=3072, n_heads=32, n_kv_heads=32, d_ff=8192,
    vocab=32064, embed_input=False, rope_theta=1e4,
    notes="patch-embedding stub frontend; full attention (no long_500k)",
)
