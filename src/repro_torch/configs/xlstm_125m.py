# Verbatim copy of repro/configs/xlstm_125m.py (plain data); only the imports may differ.
"""Assigned architecture config — exact values from the public pool."""
from .base import ArchConfig

CONFIG = ArchConfig(
    # [arXiv:2405.04517; unverified] — sLSTM + mLSTM blocks, no FFN (d_ff=0).
    # 12 layers as 2×(5 mLSTM + 1 sLSTM) ≈ the paper's m:s ratio.
    name="xlstm-125m", family="ssm",
    n_layers=12, d_model=768, n_heads=4, n_kv_heads=4, d_ff=0,
    vocab=50304, pattern=("mlstm", "mlstm", "mlstm", "mlstm", "mlstm", "slstm"),
    sub_quadratic=True, norm="layernorm",
    notes="linear recurrence → long_500k runs; no FFN per assignment",
)
