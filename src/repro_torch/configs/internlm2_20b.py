"""internlm2-20b [dense]: 48L d=6144 48H (GQA kv=8) ff=16384 vocab=92544.

[arXiv:2403.17297; hf].  long_500k SKIPPED.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, d_ff=16384,
    vocab=92_544, head_dim=128, tie_embeddings=False,
)
