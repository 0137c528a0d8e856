"""yi-9b — llama-arch GQA decoder [arXiv:2403.04652; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4,
    d_ff=11008, vocab=64000,
    source="[arXiv:2403.04652; hf]",
)

SMOKE = CONFIG.replace(name="yi-9b-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=1, d_ff=160, vocab=512)
