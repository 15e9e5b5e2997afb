"""zamba2-2.7b [hybrid]: 54L mamba2 d=2560 + shared attention blocks
(32H, kv=32, ff=10240), ssm_state=64 [arXiv:2411.15242; hf].

Shared transformer block re-applied every 6 SSM layers (9 sites), single
parameter set, per-site KV cache.  long_500k RUNS.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32, d_ff=10240,
    vocab=32_000, head_dim=80, ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    hybrid_period=6,
)
