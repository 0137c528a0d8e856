"""whisper-large-v3 — encoder-decoder transformer backbone
[arXiv:2212.04356; unverified].

Backbone only per the assignment: the conv frontend is a STUB —
input_specs() feeds precomputed frame embeddings [B, S, d_model] to the
encoder (matching the published 32-enc + 32-dec layout, d=1280, 20 heads).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-large-v3", family="encdec",
    n_layers=32, n_enc_layers=32, d_model=1280, n_heads=20, n_kv_heads=20,
    d_ff=5120, vocab=51866, head_pad_to=16,
    source="[arXiv:2212.04356; unverified]",
)

SMOKE = CONFIG.replace(name="whisper-smoke", head_pad_to=1, n_layers=2, n_enc_layers=2,
                       d_model=64, n_heads=4, n_kv_heads=4, d_ff=128,
                       vocab=512)
