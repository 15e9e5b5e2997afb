"""chameleon-34b [vlm]: 48L d=8192 64H (GQA kv=8) ff=22016 vocab=65536.

Early-fusion VLM: VQ image tokens share the 65536 vocabulary
[arXiv:2405.09818; unverified].  Frontend = STUB (input_specs provides
token ids; the VQ-GAN tokenizer is out of scope).  long_500k SKIPPED.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="chameleon-34b", family="vlm",
    n_layers=48, d_model=8192, n_heads=64, n_kv_heads=8, d_ff=22016,
    vocab=65_536, head_dim=128, tie_embeddings=False,
    frontend="vq_tokens",
    notes="banking applies to the shared VQ codebook embedding",
)
