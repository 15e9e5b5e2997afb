"""olmoe-1b-7b [moe]: 16L d=2048 16H (GQA kv=16) ff=1024/expert
vocab=50304, 64 experts top-8 [arXiv:2409.02060; hf].

FO=8 dispatch crossbar: the paper's fan-out metric literally sizes the
expert all-to-all.  long_500k SKIPPED.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="olmoe-1b-7b", family="moe",
    n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16, d_ff=1024,
    vocab=50_304, head_dim=128, tie_embeddings=False,
    n_experts=64, top_k=8, moe_d_ff=1024, shared_expert=False,
)
