"""Architecture config schema + registry + assigned input shapes (copy of
``repro.configs.base``: plain dataclasses, no framework).

One file per assigned architecture lives next to this module; each exposes
``CONFIG`` (the exact published dims) and ``SMOKE`` (a reduced same-family
variant for CPU smoke tests).  ``repro_torch.configs.get(name)`` resolves either.
"""
from __future__ import annotations

import dataclasses
import importlib
from typing import Optional

FAMILIES = ("dense", "moe", "hybrid", "encdec", "vlm", "ssm")


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0           # 0 -> d_model // n_heads
    # MoE
    n_experts: int = 0
    n_shared_experts: int = 0
    experts_per_token: int = 0
    moe_d_ff: int = 0
    capacity_factor: float = 1.25
    # hybrid (zamba-style): shared attn+MLP block applied every k SSM layers
    attn_every: int = 0
    # SSM
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    # enc-dec
    n_enc_layers: int = 0
    # vlm
    n_img_tokens: int = 0
    # common
    head_pad_to: int = 1        # pad heads to this multiple (16 on the pod)
    rope_theta: float = 500_000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    # distribution knobs (overridable per dry-run cell)
    fsdp: bool = False          # ZeRO-3: shard params+opt over the data axis
    remat: bool = True          # rematerialize each layer in the backward pass
    train_microbatches: int = 4  # grad-accumulation splits of the global batch
    # attention flash-chunking block sizes (train/prefill path)
    q_block: int = 512
    kv_block: int = 1024
    # source citation ([source; verified-tier] from the assignment)
    source: str = ""

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family}")

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_groups(self) -> int:
        return self.n_heads // max(self.n_kv_heads, 1)

    # -- zero-masked head padding (exact; Megatron-style) ---------------
    # When n_heads doesn't divide the 16-way model axis, padded heads with
    # zero wq/wo (kept zero by an output mask, so grads never touch them)
    # make the layout shardable with +pad compute, NO extra collectives,
    # and bit-exact semantics.  GQA pads the group (q-heads per kv head);
    # MHA pads kv+q together.  head_pad_to=1 (default) is a no-op.
    @property
    def padded_kv_heads(self) -> int:
        if self.head_pad_to <= 1 or self.q_groups > 1:
            return self.n_kv_heads
        return -(-self.n_kv_heads // self.head_pad_to) * self.head_pad_to

    @property
    def padded_q_groups(self) -> int:
        if self.head_pad_to <= 1 or self.q_groups == 1:
            return self.q_groups
        g = self.q_groups
        while (self.n_kv_heads * g) % self.head_pad_to:
            g += 1
        return g

    @property
    def padded_heads(self) -> int:
        return self.padded_kv_heads * self.padded_q_groups

    @property
    def padded_vocab(self) -> int:
        """vocab padded to a multiple of 2048 so a 16-way model shard stays
        128-lane aligned (padding overhead <= 4%, reported in roofline)."""
        return -(-self.vocab // 2048) * 2048

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    """One assigned input-shape cell."""

    name: str
    seq_len: int
    global_batch: int
    kind: str                    # "train" | "prefill" | "decode"
    needs_subquadratic: bool = False


SHAPES = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode",
                           needs_subquadratic=True),
}

# families whose decode path is sub-quadratic in context (O(1)-state or
# linear-cost shared-attention reads) — the only ones that run long_500k.
SUBQUADRATIC_FAMILIES = ("ssm", "hybrid")

ARCH_IDS = (
    "granite_3_8b",
    "yi_34b",
    "yi_9b",
    "llama3_8b",
    "kimi_k2_1t_a32b",
    "deepseek_moe_16b",
    "zamba2_2_7b",
    "whisper_large_v3",
    "internvl2_2b",
    "rwkv6_7b",
)


def canonical(name: str) -> str:
    return name.replace("-", "_").replace(".", "_")


def get(name: str, smoke: bool = False) -> ArchConfig:
    mod = importlib.import_module(f"{__package__}.{canonical(name)}")
    return mod.SMOKE if smoke else mod.CONFIG


def shape_applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """Whether (arch x shape) is an executable cell; else the skip reason
    (DESIGN.md §Arch-applicability)."""
    if shape.needs_subquadratic and cfg.family not in SUBQUADRATIC_FAMILIES:
        return False, ("full-attention decode is O(seq) memory per replica at "
                       "524k context; sanctioned skip for pure full-attention "
                       "archs (run for ssm/hybrid only)")
    return True, ""


def all_cells():
    """All 40 assigned (arch, shape) cells, applicable or not."""
    for arch in ARCH_IDS:
        cfg = get(arch)
        for shape in SHAPES.values():
            ok, reason = shape_applicable(cfg, shape)
            yield cfg, shape, ok, reason
