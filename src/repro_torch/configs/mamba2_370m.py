"""mamba2-370m [ssm]: 48L d=1024, attention-free, ssm_state=128 (SSD)
[arXiv:2405.21060; unverified].

Attention-free: attention-sharding aspects of the paper are inapplicable
(DESIGN.md Arch-applicability); the solver instead banks the (H, P, N)
SSD state across the model axis.  long_500k RUNS (O(1) decode state).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", family="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0, d_ff=0,
    vocab=50_280, ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
)
