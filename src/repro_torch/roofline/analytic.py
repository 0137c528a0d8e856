"""Analytic FLOPs / HBM-traffic model per (arch x shape) cell (PyTorch
mirror of ``repro.roofline.analytic``, function for function; the
parameter count comes from ``init_params`` under FakeTensorMode, which
allocates nothing).

Why analytic: XLA's cost_analysis counts while-loop bodies once, and all
per-layer compute lives inside the layer scan (hlo.py measures the
undercount at ~trip-count x).  Matmul terms below are exact (they are the
model definition); attention/SSD/WKV terms count the blocks the
implementation actually computes (e.g. the causal flash path computes
masked blocks — that waste is *supposed* to show up in the roofline, and
§Perf iterates on it).  HBM traffic uses a stated coarse model (constants
documented inline); the collective term comes from the HLO walk (hlo.py),
not from here.

All numbers are GLOBAL (whole cluster); divide by mesh size for per-chip.
"""
from __future__ import annotations

import dataclasses
import functools
import math

from ..configs.base import ArchConfig, ShapeSpec

BF16 = 2


@dataclasses.dataclass
class CellCost:
    flops_computed: float        # what the implementation executes
    flops_useful: float          # mask-aware / drop-aware useful work
    hbm_bytes: float             # coarse per-step traffic model
    params_bytes: float
    notes: dict


def _attn_proj_flops(cfg: ArchConfig, tokens: float) -> tuple[float, float]:
    """(computed, useful): computed includes zero-masked head padding."""
    d, hd = cfg.d_model, cfg.resolved_head_dim
    qo_c = 2 * d * cfg.padded_heads * hd * 2       # wq + wo (padded layout)
    kv_c = 2 * d * cfg.padded_kv_heads * hd * 2    # wk + wv
    qo_u = 2 * d * cfg.n_heads * hd * 2
    kv_u = 2 * d * cfg.n_kv_heads * hd * 2
    return tokens * (qo_c + kv_c), tokens * (qo_u + kv_u)


def _attn_score_flops(cfg: ArchConfig, B: float, S: float, causal: bool
                      ) -> tuple[float, float]:
    """(computed, useful) score+PV flops.  The flash path computes every
    block (causal usefulness (S+1)/2S), and computes padded heads."""
    hd = cfg.resolved_head_dim
    full = 4.0 * B * cfg.padded_heads * S * S * hd
    useful = 4.0 * B * cfg.n_heads * S * S * hd \
        * ((S + 1) / (2 * S) if causal else 1.0)
    return full, useful


def _mlp_flops(cfg: ArchConfig, tokens: float) -> float:
    return tokens * 6 * cfg.d_model * cfg.d_ff


def _moe_flops(cfg: ArchConfig, tokens: float) -> tuple[float, float]:
    """(computed incl. capacity padding, useful top-k)."""
    useful = tokens * cfg.experts_per_token * 6 * cfg.d_model * cfg.moe_d_ff
    computed = useful * cfg.capacity_factor
    if cfg.n_shared_experts:
        sh = tokens * 6 * cfg.d_model * cfg.n_shared_experts * cfg.moe_d_ff
        useful += sh
        computed += sh
    # router
    computed += tokens * 2 * cfg.d_model * cfg.n_experts
    useful += tokens * 2 * cfg.d_model * cfg.n_experts
    return computed, useful


def _mamba_flops(cfg: ArchConfig, tokens: float, chunk: int = 128) -> float:
    d, di, N = cfg.d_model, cfg.ssm_inner, cfg.ssm_state
    H, P = cfg.ssm_heads, cfg.ssm_head_dim
    proj = tokens * 2 * d * (2 * di + 2 * N + H) + tokens * 2 * di * d
    conv = tokens * 2 * cfg.ssm_conv * (di + 2 * N)
    Lc = chunk
    intra = tokens * 2 * Lc * (N + H * P)       # cb + y_intra einsums
    inter = tokens * 4 * H * N * P              # chunk states + y_inter
    return proj + conv + intra + inter


def _rwkv_flops(cfg: ArchConfig, tokens: float, chunk: int = 64) -> float:
    d, dff = cfg.d_model, cfg.d_ff
    hd = cfg.ssm_head_dim
    proj = tokens * 2 * d * d * 6               # r,k,v,g,o + cm_wr
    lora = tokens * 2 * d * 64 * 2
    intra = tokens * 2 * chunk * d * 2          # scores + y einsums
    state = tokens * 4 * d * hd
    cm = tokens * 2 * d * dff * 2
    return proj + lora + intra + state + cm


def _logits_flops(cfg: ArchConfig, tokens: float) -> float:
    return tokens * 2 * cfg.d_model * cfg.padded_vocab


def _per_layer_fwd(cfg: ArchConfig, B: float, S: float):
    """(computed, useful) forward flops for ONE layer of each kind."""
    tokens = B * S
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        pc, pu = _attn_score_flops(cfg, B, S, causal=True)
        prc, pru = _attn_proj_flops(cfg, tokens)
        if fam == "moe":
            fc, fu = _moe_flops(cfg, tokens)
        else:
            fc = fu = _mlp_flops(cfg, tokens)
        return prc + pc + fc, pru + pu + fu
    raise ValueError(fam)


def cell_cost(cfg: ArchConfig, shape: ShapeSpec) -> CellCost:
    B, S = float(shape.global_batch), float(shape.seq_len)
    tokens = B * S
    fam = cfg.family
    notes = {}

    # ---------------- forward flops by family ----------------
    if fam in ("dense", "vlm", "moe"):
        c1, u1 = _per_layer_fwd(cfg, B, S)
        fwd_c, fwd_u = c1 * cfg.n_layers, u1 * cfg.n_layers
    elif fam == "encdec":
        prc, pru = _attn_proj_flops(cfg, tokens)
        pc_e, pu_e = _attn_score_flops(cfg, B, S, causal=False)
        enc = (prc + pc_e + _mlp_flops(cfg, tokens)) * cfg.n_enc_layers
        enc_u = (pru + pu_e + _mlp_flops(cfg, tokens)) * cfg.n_enc_layers
        pc_d, pu_d = _attn_score_flops(cfg, B, S, causal=True)
        pc_x, pu_x = _attn_score_flops(cfg, B, S, causal=False)
        dec_c = (prc * 2 + pc_d + pc_x +
                 _mlp_flops(cfg, tokens)) * cfg.n_layers
        dec_u = (pru * 2 + pu_d + pu_x +
                 _mlp_flops(cfg, tokens)) * cfg.n_layers
        fwd_c, fwd_u = enc + dec_c, enc_u + dec_u
    elif fam == "hybrid":
        m = _mamba_flops(cfg, tokens) * cfg.n_layers
        n_sh = cfg.n_layers // cfg.attn_every
        pc, pu = _attn_score_flops(cfg, B, S, causal=True)
        prc, pru = _attn_proj_flops(cfg, tokens)
        sh_c = (prc + pc + _mlp_flops(cfg, tokens)) * n_sh
        sh_u = (pru + pu + _mlp_flops(cfg, tokens)) * n_sh
        fwd_c, fwd_u = m + sh_c, m + sh_u
    elif fam == "ssm":
        fwd_c = fwd_u = _rwkv_flops(cfg, tokens) * cfg.n_layers
    else:
        raise ValueError(fam)

    fwd_c += _logits_flops(cfg, tokens if shape.kind == "train" else B)
    fwd_u += _logits_flops(cfg, tokens if shape.kind == "train" else B)

    # ---------------- shape kind ----------------
    params_bytes = _params_bytes(cfg)
    if shape.kind == "train":
        mult = 3.0 + (1.0 if cfg.remat else 0.0)   # fwd + bwd(2x) + remat
        flops_c, flops_u = fwd_c * mult, fwd_u * 3.0
        act_traffic = tokens * cfg.d_model * _n_blocks(cfg) * 24 * BF16
        hbm = (params_bytes * (3 + cfg.train_microbatches)
               + 2.5 * _opt_bytes(cfg) + act_traffic)
        notes["remat_extra_fwd"] = cfg.remat
    elif shape.kind == "prefill":
        flops_c, flops_u = fwd_c, fwd_u
        act_traffic = tokens * cfg.d_model * _n_blocks(cfg) * 8 * BF16
        hbm = params_bytes + act_traffic + _cache_bytes(cfg, B, S)
    else:  # decode: one token per sequence against an S-long cache
        dec_c = _decode_flops(cfg, B, S)
        flops_c = flops_u = dec_c
        hbm = _decode_params_touched(cfg, B) + _cache_bytes(cfg, B, S) + \
            B * cfg.d_model * _n_blocks(cfg) * 8 * BF16
        notes["cache_bytes"] = _cache_bytes(cfg, B, S)

    return CellCost(flops_computed=flops_c, flops_useful=flops_u,
                    hbm_bytes=hbm, params_bytes=params_bytes, notes=notes)


def _n_blocks(cfg: ArchConfig) -> int:
    n = cfg.n_layers + (cfg.n_enc_layers or 0)
    if cfg.family == "hybrid":
        n += cfg.n_layers // cfg.attn_every
    return n


def _params_bytes(cfg: ArchConfig) -> float:
    return float(_param_count(cfg)) * BF16


@functools.lru_cache(maxsize=None)
def _param_count(cfg: ArchConfig) -> int:
    from torch._subclasses.fake_tensor import FakeTensorMode

    from .. import pytree
    from ..models import init_params
    with FakeTensorMode():
        params = init_params(cfg, 0, device="cpu")
    return sum(math.prod(x.shape) for x in pytree.leaves(params))


def _opt_bytes(cfg: ArchConfig) -> float:
    per_param = 2.0 if cfg.fsdp else 8.0     # int8 m+v vs f32 m+v
    return _param_count(cfg) * per_param


def _cache_bytes(cfg: ArchConfig, B: float, S: float) -> float:
    hd, kv = cfg.resolved_head_dim, cfg.padded_kv_heads
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        return cfg.n_layers * B * S * kv * hd * 2 * BF16
    if fam == "encdec":
        return cfg.n_layers * B * S * kv * hd * 4 * BF16   # self + cross
    if fam == "hybrid":
        n_sh = cfg.n_layers // cfg.attn_every
        attn = n_sh * B * S * kv * hd * 2 * BF16
        ssm = cfg.n_layers * B * cfg.ssm_heads * cfg.ssm_state * \
            cfg.ssm_head_dim * 4
        return attn + ssm
    if fam == "ssm":
        hd6 = cfg.ssm_head_dim
        return cfg.n_layers * B * (cfg.d_model // hd6) * hd6 * hd6 * 4
    raise ValueError(fam)


def _decode_params_touched(cfg: ArchConfig, B: float) -> float:
    """Weight bytes actually read for one decode step: dense weights fully;
    routed experts only those hit by B*k assignments."""
    total = _params_bytes(cfg)
    if not cfg.n_experts:
        return total
    routed = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * \
        cfg.n_layers * BF16
    frac = min(1.0, B * cfg.experts_per_token / cfg.n_experts)
    return total - routed + routed * frac


def _decode_flops(cfg: ArchConfig, B: float, S: float) -> float:
    """One-token decode: 2*active-params matmuls + cache-read attention."""
    dense = 2.0 * _active_params(cfg) * B
    fam = cfg.family
    if fam in ("dense", "vlm", "moe"):
        attn = 4.0 * B * cfg.n_heads * S * cfg.resolved_head_dim * cfg.n_layers
    elif fam == "encdec":
        attn = 8.0 * B * cfg.n_heads * S * cfg.resolved_head_dim * cfg.n_layers
    elif fam == "hybrid":
        n_sh = cfg.n_layers // cfg.attn_every
        attn = 4.0 * B * cfg.n_heads * S * cfg.resolved_head_dim * n_sh
        attn += 4.0 * B * cfg.ssm_heads * cfg.ssm_state * cfg.ssm_head_dim \
            * cfg.n_layers
    else:  # ssm: O(1) state update
        attn = 4.0 * B * cfg.d_model * cfg.ssm_head_dim * cfg.n_layers
    return dense + attn


def _active_params(cfg: ArchConfig) -> float:
    total = _param_count(cfg)
    if not cfg.n_experts:
        return float(total)
    routed = 3 * cfg.n_experts * cfg.d_model * cfg.moe_d_ff * cfg.n_layers
    return float(total - routed
                 + routed * cfg.experts_per_token / cfg.n_experts)
