"""llama4-maverick-400b-a17b [moe]: 48L d=5120 40H (GQA kv=8) ff=8192
vocab=202048, MoE 128 experts top-1 + always-on shared expert
[hf:meta-llama/Llama-4 family; unverified].

Expert dispatch IS the paper's banking problem (DESIGN.md Sec 2): 128
experts = banks, router = access pattern, capacity = ports.
long_500k SKIPPED (chunked-attention variant not modelled).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama4-maverick-400b-a17b", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_ff=8192,
    vocab=202_048, head_dim=128, tie_embeddings=False,
    n_experts=128, top_k=1, moe_d_ff=8192, shared_expert=True,
)
