"""First-party AdamW with quantized moments (PyTorch mirror of
``repro.optim.adamw``).

moment_dtype:
  "float32" — standard AdamW.
  "bfloat16" — bf16 moments (2x smaller optimizer state).
  "int8"    — block-quantized int8 moments with per-block f32 scales
              (block = last axis, 128 wide): ~4x smaller state.

The optimizer state mirrors the param tree leaf for leaf.  ``apply_update``
is functional, as the reference's: it returns new tensors and leaves its
inputs as they were.  ``opt_pspecs`` waits for sharding (ROADMAP A.8.3).
"""
from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from .. import pytree

F32 = torch.float32
_BLOCK = 128


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8


@dataclasses.dataclass
class QTensor:
    """Block-quantized int8 tensor, blocked along the LAST axis (the
    quantized layout is a reshape of the parameter's).

    Linear mode (signed, first moment): x ~ q * scale.
    Log mode (positive, second moment): x ~ exp(offset + (q+127) * scale);
    log space keeps *relative* precision, where linear int8 would floor a
    small v to 0 and make 1/sqrt(v) explode.

    q: int8 [..., n_blk, 128]; scale/offset: f32 [..., n_blk, 1].  A tree
    node of three children (q, scale, offset) with ``log`` static, as the
    reference registers it."""
    q: torch.Tensor
    scale: torch.Tensor
    offset: torch.Tensor
    log: bool = False


pytree.register_node(QTensor, lambda t: ((t.q, t.scale, t.offset), t.log),
                     lambda log, ch: QTensor(q=ch[0], scale=ch[1], offset=ch[2], log=log))


def _quantize(x: torch.Tensor, log: bool) -> QTensor:
    xr = x.reshape(x.shape if x.dim() else (1,))
    pad = (-xr.shape[-1]) % _BLOCK
    if pad:
        xr = F.pad(xr, (0, pad), value=1e-30 if log else 0.0)
    blocks = xr.reshape(*xr.shape[:-1], -1, _BLOCK)
    if log:
        lb = torch.log(torch.clamp_min(blocks, 1e-30))
        lo = lb.amin(dim=-1, keepdim=True)
        s = (lb.amax(dim=-1, keepdim=True) - lo) / 254.0
        q = torch.round((lb - lo) / torch.clamp_min(s, 1e-12)) - 127.0
        return QTensor(q=q.to(torch.int8), scale=s, offset=lo, log=True)
    s = blocks.abs().amax(dim=-1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp_min(s, 1e-20)).to(torch.int8)
    return QTensor(q=q, scale=s, offset=torch.zeros_like(s), log=False)


def _dequantize(t: QTensor, shape, size) -> torch.Tensor:
    if t.log:
        x = torch.exp(t.offset + (t.q.to(F32) + 127.0) * t.scale)
        x = torch.where(x <= 2e-30, 0.0, x)
    else:
        x = t.q.to(F32) * t.scale
    x = x.reshape(*x.shape[:-2], -1)           # unblock the last axis
    last = shape[-1] if len(shape) else 1
    if x.shape[-1] != last:
        x = x[..., :last]
    return x.reshape(shape)


def _encode(x: torch.Tensor, dtype: str, log: bool = False):
    if dtype == "int8":
        return _quantize(x, log)
    if dtype == "bfloat16":
        return x.to(torch.bfloat16)
    return x.to(F32)


def _decode(x, like: torch.Tensor, dtype: str) -> torch.Tensor:
    if dtype == "int8":
        return _dequantize(x, tuple(like.shape), like.numel())
    return x.to(F32)


def cosine_lr(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warmup, then a cosine from ``lr`` down to ``min_lr_frac * lr``;
    float32, as the reference computes it."""
    s = torch.as_tensor(step).to(F32)
    warm = s / max(cfg.warmup_steps, 1)
    prog = torch.clamp((s - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0, 1)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(s < cfg.warmup_steps, warm, cos)


class OptState(NamedTuple):
    step: torch.Tensor
    m: dict
    v: dict


def init_opt_state(params, cfg: AdamWConfig) -> OptState:
    """Zero moments (encoded in ``cfg.moment_dtype``) and step 0, on the
    params' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=F32, device=p.device)
    m = pytree.tree_map(lambda p: _encode(zeros(p), cfg.moment_dtype, log=False), params)
    v = pytree.tree_map(lambda p: _encode(zeros(p), cfg.moment_dtype, log=True), params)
    dev = pytree.leaves(params)[0].device
    return OptState(step=torch.zeros((), dtype=torch.int32, device=dev), m=m, v=v)


def global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.to(F32))) for x in pytree.leaves(tree)))


def _is_q(x) -> bool:
    return isinstance(x, QTensor)


def apply_update(params, grads, state: OptState, cfg: AdamWConfig):
    """Returns (params', state', metrics)."""
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    gnorm = global_norm(grads)
    scale = torch.clamp_max(cfg.clip_norm / torch.clamp_min(gnorm, 1e-9), 1.0)
    b1c = 1 - cfg.b1 ** step.to(F32)
    b2c = 1 - cfg.b2 ** step.to(F32)

    def upd(p, g, m_enc, v_enc):
        g = g.to(F32) * scale
        m = cfg.b1 * _decode(m_enc, p, cfg.moment_dtype) + (1 - cfg.b1) * g
        v = cfg.b2 * _decode(v_enc, p, cfg.moment_dtype) + (1 - cfg.b2) * g * g
        upd_ = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        decay = cfg.weight_decay if p.dim() >= 2 else 0.0   # no WD on norms
        pf = p.to(F32)
        newp = pf - lr * (upd_ + decay * pf)
        return (newp.to(p.dtype), _encode(m, cfg.moment_dtype, log=False),
                _encode(v, cfg.moment_dtype, log=True))

    # flatten by the params' structure; moments keep QTensor nodes as leaves
    p_flat, unflatten = pytree.flatten(params)
    g_flat = pytree.leaves(grads)
    m_flat = pytree.leaves(state.m, is_leaf=_is_q)
    v_flat = pytree.leaves(state.v, is_leaf=_is_q)
    out = [upd(p, g, m, v) for p, g, m, v in zip(p_flat, g_flat, m_flat, v_flat)]
    newp, newm, newv = (unflatten([t[i] for t in out]) for i in range(3))
    metrics = {"grad_norm": gnorm, "lr": lr}
    return newp, OptState(step=step, m=newm, v=newv), metrics
