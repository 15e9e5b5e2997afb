"""Architecture configuration schema.

One dataclass covers all ten assigned families (dense / moe / ssm / hybrid /
encdec / vlm); family-specific fields are zero/None when unused.  Full-size
configs are exercised only through the dry-run (ShapeDtypeStruct, no
allocation); ``reduced()`` derives the smoke-test configuration.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None   # default d_model // n_heads
    # attention flavour
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    sliding_window: int = 0          # >0: local-attention window size
    local_global_ratio: int = 0      # gemma3: N local layers per global layer
    mlp_act: str = "swiglu"          # swiglu | gelu
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0                # per-expert hidden dim (olmoe: 1024)
    shared_expert: bool = False      # llama4: always-on shared FFN
    capacity_factor: float = 1.25
    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    # hybrid (zamba2): one shared attention block applied every k SSM blocks
    hybrid_period: int = 0
    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    # modality frontend stub: None | "vq_tokens" | "audio_frames"
    frontend: Optional[str] = None
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # notes for DESIGN/EXPERIMENTS (e.g. applicability of paper technique)
    notes: str = ""

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Eligible for long_500k (see DESIGN.md Arch-applicability)."""
        return (self.family in ("ssm", "hybrid")
                or (self.sliding_window > 0 and self.local_global_ratio > 0))

    def reduced(self) -> "ArchConfig":
        """Small same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 if self.family != "hybrid" else 4),
            d_model=128,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads else 0,
            d_ff=256,
            vocab=512,
            head_dim=32,
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            moe_d_ff=64 if self.moe_d_ff else 0,
            ssm_state=16 if self.ssm_state else 0,
            ssm_head_dim=16 if self.ssm_state else 64,
            ssm_chunk=16 if self.ssm_state else 256,
            hybrid_period=2 if self.hybrid_period else 0,
            n_encoder_layers=min(self.n_encoder_layers, 2),
        )


@dataclass(frozen=True)
class ShapeConfig:
    """One input-shape cell (assigned per architecture)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode | long_decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "long_decode"),
}
