"""rwkv6-7b (Finch) — attention-free linear RNN with data-dependent decay
[arXiv:2404.05892; hf].

64 WKV heads of dim 64 (d_model 4096); channel-mix d_ff 14336.  Decode is
O(1)-state, so this arch runs the long_500k cell.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=64, n_kv_heads=64,
    d_ff=14336, vocab=65536, ssm_head_dim=64,
    source="[arXiv:2404.05892; hf]",
)

SMOKE = CONFIG.replace(name="rwkv6-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
                       ssm_head_dim=16)
