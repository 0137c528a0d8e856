"""zamba2-2.7b — Mamba2 backbone + shared attention block every 6 layers
[arXiv:2411.15242; hf].

54 Mamba2 layers; one weight-shared {GQA attention + SwiGLU} block applied
after every 6th SSM layer (9 applications).  The published model also
concatenates the initial embedding into the shared block input and applies
per-invocation LoRA deltas; both are simplified away here (DESIGN.md §5).
"""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b", family="hybrid",
    n_layers=54, d_model=2560, n_heads=32, n_kv_heads=32,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_expand=2, ssm_head_dim=64, attn_every=6,
    source="[arXiv:2411.15242; hf]",
)

SMOKE = CONFIG.replace(name="zamba2-smoke", n_layers=4, d_model=64,
                       n_heads=4, n_kv_heads=4, d_ff=128, vocab=512,
                       ssm_state=16, ssm_head_dim=16, attn_every=2)
