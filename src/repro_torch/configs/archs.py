# Verbatim copy of repro/configs/archs.py (plain data); only the imports may differ.
"""Registry of the 10 assigned architectures (one module per arch)."""
from __future__ import annotations

from .base import ArchConfig
from .mixtral_8x22b import CONFIG as MIXTRAL_8X22B
from .musicgen_medium import CONFIG as MUSICGEN_MEDIUM
from .phi3_vision_4_2b import CONFIG as PHI3_VISION_4_2B
from .qwen1_5_0_5b import CONFIG as QWEN1_5_0_5B
from .qwen2_0_5b import CONFIG as QWEN2_0_5B
from .qwen3_1_7b import CONFIG as QWEN3_1_7B
from .qwen3_moe_235b_a22b import CONFIG as QWEN3_MOE_235B
from .recurrentgemma_9b import CONFIG as RECURRENTGEMMA_9B
from .starcoder2_7b import CONFIG as STARCODER2_7B
from .xlstm_125m import CONFIG as XLSTM_125M

ARCHS: dict[str, ArchConfig] = {
    c.name: c for c in (
        MUSICGEN_MEDIUM, MIXTRAL_8X22B, QWEN3_MOE_235B, QWEN2_0_5B,
        QWEN3_1_7B, QWEN1_5_0_5B, STARCODER2_7B, XLSTM_125M,
        PHI3_VISION_4_2B, RECURRENTGEMMA_9B,
    )
}
