# Verbatim copy of repro/configs/musicgen_medium.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [arXiv:2306.05284; hf] — decoder-only over EnCodec tokens.  Modality
    # frontend (EnCodec + codebook interleaving) is a STUB: input_specs()
    # provides precomputed frame embeddings (B, S, d_model).
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, d_ff=6144,
    vocab=2048, embed_input=False, norm="layernorm", act="gelu",
    notes="frame-embedding stub frontend; full attention (no long_500k)",
)
