"""Mamba2 (SSD) block, the zamba2 backbone layer (PyTorch mirror of
``repro.models.ssm``).

Chunked state-space-dual algorithm: within a chunk the output is an
attention-like lower-triangular contraction with per-head scalar decay;
across chunks a loop carries the [B, H, N, P] state (the reference's
scan).  Every decay exponential is a difference of a within-chunk
cumulative sum, so every factor is <= 1.  The casts to float32 and back
sit at the reference's points: the conv's SiLU, the SSD itself, the gate's
SiLU.

Prefill returns the final (conv window, SSM state), from which the
O(1)-a-token decode step goes on.  With DTensor activations the SSD runs
on each rank's local shards (``_ssd_local``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..core.simulator import resolve_device
from .layers import (F32, _fill, _silu_as, dense_init, dtype_of, rmsnorm, rmsnorm_params,
                     rmsnorm_pspecs)
from .sharding import constrain, logical_pspec as LP


class SSMState(NamedTuple):
    conv: torch.Tensor    # [B, k-1, conv_dim] rolling conv window
    ssm: torch.Tensor     # [B, H, N, P] recurrent state (float32)


def mamba2_params(key: torch.Generator, cfg, out: Optional[dict] = None) -> dict:
    """The block's weights in ``cfg.dtype``; ``A_log``, ``D`` and
    ``dt_bias`` float32.  Drawn from the generator ``key`` on its device;
    with ``out`` (one layer's slices of stacked tensors) written into it."""
    d, di, N, H = cfg.d_model, cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads
    k = cfg.ssm_conv
    dt, dev = dtype_of(cfg), key.device
    out = out or {}
    return {
        "wz": dense_init(key, d, (d, di), dt, out.get("wz")),
        "wx": dense_init(key, d, (d, di), dt, out.get("wx")),
        "wB": dense_init(key, d, (d, N), dt, out.get("wB")),
        "wC": dense_init(key, d, (d, N), dt, out.get("wC")),
        "wdt": dense_init(key, d, (d, H), dt, out.get("wdt")),
        "conv_w": dense_init(key, k, (k, di + 2 * N), dt, out.get("conv_w")),
        "conv_b": _fill((di + 2 * N,), 0.0, dt, dev, out.get("conv_b")),
        "A_log": _fill((H,), 0.0, F32, dev, out.get("A_log")),
        "D": _fill((H,), 1.0, F32, dev, out.get("D")),
        "dt_bias": _fill((H,), -2.0, F32, dev, out.get("dt_bias")),   # softplus(-2) ~ 0.13
        "norm": rmsnorm_params(di, dt, dev, out.get("norm")),
        "wo": dense_init(key, di, (di, d), dt, out.get("wo")),
    }


def mamba2_pspecs(cfg) -> dict:
    return {
        "wz": LP("embed_fsdp", "ssm_inner"),
        "wx": LP("embed_fsdp", "ssm_inner"),
        "wB": LP("embed_fsdp", None),
        "wC": LP("embed_fsdp", None),
        "wdt": LP("embed_fsdp", "ssm_inner"),
        "conv_w": LP(None, "ssm_inner"),
        "conv_b": LP("ssm_inner"),
        "A_log": LP("ssm_inner"),
        "D": LP("ssm_inner"),
        "dt_bias": LP("ssm_inner"),
        "norm": rmsnorm_pspecs(),
        "wo": LP("ssm_inner", "embed_fsdp"),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus`` = logaddexp(x, 0), in its own order."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 window: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv.  u: [B, S, C]; w: [k, C]; window: [B, k-1, C]
    (history; zeros for a fresh sequence)."""
    k = w.shape[0]
    if window is None:
        window = u.new_zeros((u.shape[0], k - 1, u.shape[2]))
    up = torch.cat([window, u], dim=1)
    out = sum(up[:, i:i + u.shape[1], :] * w[i][None, None, :] for i in range(k))
    return out + b[None, None, :]


def _ssd(xs, Bm, Cm, dt, A, Dp, s0, Lc: int):
    """The chunked SSD: xs [B, S, H, P], Bm / Cm [B, S, N], dt [B, S, H]
    float32, A / Dp [H], s0 [B, H, N, P] float32 or None.  Returns (y
    [B, nc, Lc, H, P] float32, the final state)."""
    B, S, H, P = xs.shape
    N = Bm.shape[-1]
    nc = S // Lc
    xs_c = xs.reshape(B, nc, Lc, H, P).to(F32)
    B_c = Bm.reshape(B, nc, Lc, N).to(F32)
    C_c = Cm.reshape(B, nc, Lc, N).to(F32)
    dt_c = dt.reshape(B, nc, Lc, H)
    dA = dt_c * A[None, None, None, :]                          # [B,nc,Lc,H]
    cum = torch.cumsum(dA, dim=2)

    # intra-chunk: Y[t] += sum_{s<=t} (C_t.B_s) exp(cum_t-cum_s) dt_s x_s
    cb = torch.einsum("bcln,bcsn->bcls", C_c, B_c)              # [B,nc,Lc,Lc]
    decay = torch.exp(cum[:, :, :, None, :] - cum[:, :, None, :, :])
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=xs.device))
    decay = torch.where(tri[None, None, :, :, None], decay, 0.0)   # [B,nc,L,L,H]
    scores = cb[..., None] * decay * dt_c[:, :, None, :, :]
    y = torch.einsum("bclsh,bcshp->bclhp", scores, xs_c)

    # chunk summary states + inter-chunk recurrence
    last = cum[:, :, -1:, :]                                    # [B,nc,1,H]
    sdecay = torch.exp(last - cum) * dt_c                       # [B,nc,Lc,H]
    S_c = torch.einsum("bcsh,bcsn,bcshp->bchnp", sdecay, B_c, xs_c)
    chunk_decay = torch.exp(last[:, :, 0, :])                   # [B,nc,H]

    s = s0 if s0 is not None else torch.zeros((B, H, N, P), dtype=F32, device=xs.device)
    s_prevs = []
    for c in range(nc):
        s_prevs.append(s)
        s = s * chunk_decay[:, c, :, None, None] + S_c[:, c]
    s_prevs = torch.stack(s_prevs, dim=1)                       # [B,nc,H,N,P]

    y_inter = torch.einsum("bcln,bchnp,bclh->bclhp", C_c, s_prevs, torch.exp(cum))
    return y + y_inter + (Dp[None, None, None, :, None] * xs_c), s


def _ssd_local(xs, Bm, Cm, dt, A, Dp, s0, Lc: int):
    """``_ssd`` of DTensors on each rank's local shards (the body of a
    ``local_map``), at the placements the reference constrains xs to
    (batch, seq, ssm_inner): the SSD is independent across batch rows and
    heads; B and C are whole on every head shard, so their gradients are
    partial sums there."""
    mesh = xs.device_mesh
    pl = xs.placements
    if any(isinstance(q, Shard) and q.dim in (1, 3) for q in pl):
        raise ValueError(f"the SSD over a sharded sequence or head dim: {pl}")

    def like(on_b, on_h):
        return tuple(on_b if q == Shard(0) else on_h if q == Shard(2) else Replicate()
                     for q in pl)

    def local(t, want, grad=None):
        return t.redistribute(mesh, want).to_local(grad_placements=grad or want)

    heads = like(Replicate(), Shard(0))
    y, s = _ssd(local(xs, pl), local(Bm, like(Shard(0), Replicate()), like(Shard(0), Partial())),
                local(Cm, like(Shard(0), Replicate()), like(Shard(0), Partial())),
                local(dt, pl), local(A, heads), local(Dp, heads),
                None if s0 is None else local(s0, like(Shard(0), Shard(1))), Lc)
    return (DTensor.from_local(y, mesh, like(Shard(0), Shard(3)), run_check=False),
            DTensor.from_local(s, mesh, like(Shard(0), Shard(1)), run_check=False))


def mamba2_fwd(p: dict, cfg, x: torch.Tensor, *, chunk: int = 128,
               state: Optional[SSMState] = None, return_state: bool = False):
    """x: [B, S, D] -> [B, S, D] (and the final SSMState if asked)."""
    B, S, D = x.shape
    di, N, H, P = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    Lc = min(chunk, S)
    if S % Lc:
        raise ValueError(f"chunk {Lc} does not divide S={S}")
    x = constrain(x, "batch", "seq", None)       # whole on every model rank

    z = x @ p["wz"]
    xs = x @ p["wx"]
    Bm = x @ p["wB"]
    Cm = x @ p["wC"]
    dt_r = x @ p["wdt"]

    raw = torch.cat([xs, Bm, Cm], dim=-1)
    conv_win = state.conv if state is not None else None
    u = _silu_as(_causal_conv(raw, p["conv_w"], p["conv_b"], conv_win), x.dtype)
    hist = conv_win if conv_win is not None else \
        x.new_zeros((B, cfg.ssm_conv - 1, di + 2 * N))
    new_conv = torch.cat([hist, raw], dim=1)[:, -(cfg.ssm_conv - 1):]
    xs, Bm, Cm = torch.split(u, [di, N, N], dim=-1)

    dt = _softplus(dt_r.to(F32) + p["dt_bias"])                 # [B, S, H]
    A = -torch.exp(p["A_log"])                                  # [H], < 0

    xs = constrain(xs.reshape(B, S, H, P), "batch", "seq", "ssm_inner", None)

    s0 = state.ssm.to(F32) if state is not None else None
    ssd = _ssd_local if isinstance(xs, DTensor) else _ssd
    y, s = ssd(xs, Bm, Cm, dt, A, p["D"], s0, Lc)
    y = constrain(y.reshape(B, S, di).to(x.dtype), "batch", "seq", "ssm_inner")

    y = constrain(rmsnorm(p["norm"], y, cfg.norm_eps), "batch", "seq", "ssm_inner")
    y = y * _silu_as(z, x.dtype)
    out = y @ p["wo"]
    if return_state:
        return out, SSMState(conv=new_conv, ssm=s.to(F32))
    return out


def mamba2_decode(p: dict, cfg, x: torch.Tensor, state: SSMState):
    """One-token decode.  x: [B, 1, D]; O(1) in context length."""
    B = x.shape[0]
    di, N, H, P = cfg.ssm_inner, cfg.ssm_state, cfg.ssm_heads, cfg.ssm_head_dim
    x0 = x[:, 0]

    z = x0 @ p["wz"]
    xs = x0 @ p["wx"]
    Bm = x0 @ p["wB"]
    Cm = x0 @ p["wC"]
    dt_r = x0 @ p["wdt"]

    u_new = torch.cat([xs, Bm, Cm], dim=-1)                     # [B, conv_dim]
    win = torch.cat([state.conv, u_new[:, None, :]], dim=1)     # [B, k, C]
    conv = (win * p["conv_w"][None]).sum(dim=1) + p["conv_b"]
    u = _silu_as(conv, x.dtype)
    xs, Bm, Cm = torch.split(u, [di, N, N], dim=-1)

    dt = _softplus(dt_r.to(F32) + p["dt_bias"])                 # [B, H]
    A = -torch.exp(p["A_log"])
    dec = torch.exp(dt * A)                                     # [B, H]
    xs_h = xs.reshape(B, H, P).to(F32)
    dBx = torch.einsum("bh,bn,bhp->bhnp", dt, Bm.to(F32), xs_h)
    s_new = state.ssm * dec[:, :, None, None] + dBx
    y = torch.einsum("bn,bhnp->bhp", Cm.to(F32), s_new)
    y = y + p["D"][None, :, None] * xs_h
    y = y.reshape(B, di).to(x.dtype)
    y = rmsnorm(p["norm"], y, cfg.norm_eps)
    y = y * _silu_as(z, x.dtype)
    out = (y @ p["wo"])[:, None, :]
    return out, SSMState(conv=win[:, 1:], ssm=s_new)


def ssm_state_pspecs():
    return SSMState(conv=LP("batch", None, "ssm_inner"),
                    ssm=LP("batch", "ssm_inner", None, None))


def init_ssm_state(cfg, B: int, dtype, *, device=None) -> SSMState:
    """Zero conv window in ``dtype`` and zero float32 SSM state, on
    ``device`` (the card unless named)."""
    device = resolve_device(device)
    di, N = cfg.ssm_inner, cfg.ssm_state
    return SSMState(
        conv=torch.zeros((B, cfg.ssm_conv - 1, di + 2 * N), dtype=dtype, device=device),
        ssm=torch.zeros((B, cfg.ssm_heads, N, cfg.ssm_head_dim), dtype=F32, device=device))
