"""deepseek-moe-16b — fine-grained MoE: 2 shared + 64 routed top-6
[arXiv:2401.06066; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="deepseek-moe-16b", family="moe",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=1408, vocab=102400,
    n_experts=64, n_shared_experts=2, experts_per_token=6, moe_d_ff=1408,
    source="[arXiv:2401.06066; hf]",
)

SMOKE = CONFIG.replace(name="deepseek-moe-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=64, vocab=512,
                       n_experts=8, n_shared_experts=2, experts_per_token=2,
                       moe_d_ff=64)
