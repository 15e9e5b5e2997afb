"""whisper-base [audio]: 6L enc + 6L dec, d=512 8H ff=2048 vocab=51865
[arXiv:2212.04356; unverified].

Enc-dec; conv/mel frontend is a STUB (input_specs provides precomputed
frame embeddings).  Decode shapes exercise the decoder with self + cross
KV caches.  long_500k SKIPPED (full attention; 1500-frame native context).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", family="encdec",
    n_layers=6, d_model=512, n_heads=8, n_kv_heads=8, d_ff=2048,
    vocab=51_865, head_dim=64, mlp_act="gelu", n_encoder_layers=6,
    frontend="audio_frames",
)
