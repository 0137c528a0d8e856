"""kimi-k2-1t-a32b — trillion-param MoE, 384 routed experts top-8
[arXiv:2501.kimi2; unverified].

Spec-literal: every layer is MoE with 384 routed experts (d_ff=2048 each),
top-8, no shared expert (the published K2 adds 1 shared expert + a dense
first layer; the assignment table omits them, so we follow the table —
noted in DESIGN.md).  fsdp=True by default: at ~1.03e12 params the optimizer
state must be ZeRO-sharded over the data axis (with int8 moments) to have
any chance of fitting — see EXPERIMENTS.md §Dry-run memory table.
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="kimi-k2-1t-a32b", family="moe",
    n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8, head_dim=112,
    d_ff=2048, vocab=163840,
    n_experts=384, n_shared_experts=0, experts_per_token=8, moe_d_ff=2048,
    fsdp=True,
    source="[arXiv:2501.kimi2; unverified]",
)

SMOKE = CONFIG.replace(name="kimi-k2-smoke", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, head_dim=16, d_ff=64,
                       vocab=512, n_experts=8, experts_per_token=2,
                       moe_d_ff=64, fsdp=False)
