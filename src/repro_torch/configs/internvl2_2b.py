"""internvl2-2b — InternViT + InternLM2 VLM [arXiv:2404.16821; hf].

Backbone only per the assignment: the ViT frontend is a STUB —
input_specs() provides 256 precomputed patch embeddings per sample, which
the model prepends to the token stream.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-2b", family="vlm",
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92553, n_img_tokens=256,
    source="[arXiv:2404.16821; hf]",
)

SMOKE = CONFIG.replace(name="internvl2-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, d_ff=128, vocab=512,
                       n_img_tokens=8)
