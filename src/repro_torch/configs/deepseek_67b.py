"""deepseek-67b [dense]: 95L d=8192 64H (GQA kv=8) ff=22016 vocab=102400.

Llama-architecture [arXiv:2401.02954; hf].  long_500k SKIPPED (pure full
attention; noted in DESIGN.md).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-67b", family="dense",
    n_layers=95, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=102_400, head_dim=128, tie_embeddings=False,
    notes="GQA kv=8 < model-axis 16 => solver picks bank-by-duplication "
          "for the KV cache (paper Sec 3.3)",
)
