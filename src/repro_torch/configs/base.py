# Verbatim copy of repro/configs/base.py (plain data); only the imports may differ.
"""Architecture config schema + input-shape suite (assigned cells)."""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0                # 0 → d_model // n_heads
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    window: int | None = None        # sliding-window attention
    rope_theta: float = 1e4
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # block structure: repeated pattern of layer kinds
    pattern: tuple[str, ...] = ("attn",)   # attn | mlstm | slstm | rglru
    # embedding / head
    embed_input: bool = True         # False → stub frontend provides embeddings
    tie_embeddings: bool = False
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    act: str = "silu"                # silu | gelu | geglu
    mlp_bias: bool = False
    # capability flags
    sub_quadratic: bool = False      # may run long_500k
    notes: str = ""

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks + head)."""
        d, dh = self.d_model, self.head_dim
        n = 0
        if self.embed_input:
            n += self.vocab * d
        if not self.tie_embeddings:
            n += self.vocab * d
        per_pattern = 0
        for kind in self.pattern:
            if kind == "attn":
                per_pattern += d * dh * (self.n_heads + 2 * self.n_kv_heads)
                per_pattern += self.n_heads * dh * d
            elif kind == "mlstm":
                per_pattern += 4 * d * d + 2 * d * self.n_heads
            elif kind == "slstm":
                per_pattern += 4 * d * d + d * d + self.n_heads * (d // self.n_heads) ** 2 * 4
            elif kind == "rglru":
                per_pattern += 5 * d * d
            if kind in ("attn", "rglru") and self.d_ff:
                mult = 3 if self.act in ("silu", "geglu") else 2
                per_pattern += mult * d * self.d_ff
            if self.is_moe and kind == "attn":
                f = self.moe_d_ff or self.d_ff
                per_pattern += self.n_experts * 3 * d * f + d * self.n_experts
        n += (self.n_layers * per_pattern) // len(self.pattern)
        return n

    def n_active_params(self) -> int:
        """Per-token active parameters (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        f = self.moe_d_ff or self.d_ff
        dense_moe = self.n_experts * 3 * d * f
        active_moe = self.top_k * 3 * d * f
        return self.n_params() - self.n_layers * (dense_moe - active_moe)

    def reduced(self, n_layers=2, d_model=64, n_heads=4, n_kv_heads=None,
                vocab=256, d_ff=None, n_experts=None, seq_cap=None) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        nkv = n_kv_heads if n_kv_heads is not None else max(
            1, n_heads * self.n_kv_heads // self.n_heads)
        ne = self.n_experts if n_experts is None else n_experts
        if self.is_moe and n_experts is None:
            ne = min(self.n_experts, 8)
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=max(n_layers, len(self.pattern)),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=nkv,
            head_dim=d_model // n_heads,
            d_ff=(d_ff if d_ff is not None else (d_model * 4 if self.d_ff else 0)),
            moe_d_ff=(d_model * 2 if self.moe_d_ff else 0),
            n_experts=ne,
            top_k=min(self.top_k, ne) if ne else 0,
            vocab=vocab,
            window=min(self.window, 32) if self.window else None,
        )


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str            # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
