# Verbatim copy of repro/configs/starcoder2_7b.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [arXiv:2402.19173; hf] — GQA, RoPE, layernorm + gelu, biases.
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4, d_ff=18432,
    vocab=49152, norm="layernorm", act="gelu", qkv_bias=True, mlp_bias=True,
)
