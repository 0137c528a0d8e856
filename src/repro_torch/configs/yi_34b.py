"""yi-34b — llama-arch GQA decoder [arXiv:2403.04652; hf].

56 q-heads do not divide the 16-way model axis; zero-masked head padding
(56 -> 64, exact semantics — see layers.head_mask) makes the layout shard
cleanly at +14% attention compute, reported in the roofline useful/computed
ratio.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="yi-34b", family="dense",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_pad_to=16,
    source="[arXiv:2403.04652; hf]",
)

SMOKE = CONFIG.replace(name="yi-34b-smoke", head_pad_to=1, n_layers=2, d_model=56 * 2,
                       n_heads=7, n_kv_heads=1, d_ff=256, vocab=512)
