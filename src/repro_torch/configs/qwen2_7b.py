"""qwen2-7b [dense]: 28L d=3584 28H (GQA kv=4) ff=18944 vocab=152064.

GQA with QKV bias [arXiv:2407.10671; hf].  long_500k SKIPPED.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-7b", family="dense",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, d_ff=18944,
    vocab=152_064, head_dim=128, qkv_bias=True, rope_theta=1_000_000.0,
    tie_embeddings=False,
)
