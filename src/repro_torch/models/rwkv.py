"""RWKV-6 "Finch" block: data-dependent-decay linear attention (time-mix)
plus squared-ReLU channel-mix (PyTorch mirror of ``repro.models.rwkv``).

Chunked time-mix: within a chunk the pairwise decay
exp(cum_t - logw_t - cum_s) is computed over the whole [Lc, Lc] square and
then masked to s < t, in the reference's order of operations; across
chunks a loop carries the per-head [hd, hd] state (the reference's scan).
Decode is an O(1) state update.

As in the reference, the token-shift mixing coefficients are static
learned vectors, and the decay w keeps its data-dependent LoRA.  With
DTensor activations the WKV loop runs on each rank's local shards
(``_wkv_local``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..core.simulator import resolve_device
from .layers import F32, _fill, _silu_as, dense_init, dtype_of
from .sharding import constrain, logical_pspec as LP

_LORA = 64


class RWKVState(NamedTuple):
    wkv: torch.Tensor        # [B, H, hd, hd] per-head state (float32)
    shift_att: torch.Tensor  # [B, D] previous token (time-mix)
    shift_ffn: torch.Tensor  # [B, D] previous token (channel-mix)


def _uniform(key: torch.Generator, d: int, dtype, out: Optional[torch.Tensor]):
    """U[0, 1) in float32 cast to ``dtype`` (the mixing coefficients)."""
    x = torch.rand((d,), generator=key, dtype=F32, device=key.device)
    return x.to(dtype) if out is None else out.copy_(x)


def rwkv6_params(key: torch.Generator, cfg, out: Optional[dict] = None) -> dict:
    """The block's weights in ``cfg.dtype``; ``w0``, ``u`` and
    ``ln_scale`` float32.  Drawn from the generator ``key`` on its device;
    with ``out`` (one layer's slices of stacked tensors) written into it."""
    d, dff = cfg.d_model, cfg.d_ff
    H = cfg.n_heads
    hd = cfg.d_model // H
    dt, dev = dtype_of(cfg), key.device
    out = out or {}
    mu = {n: _uniform(key, d, dt, out.get(n))
          for n in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "cm_mu_k", "cm_mu_r")}
    w = {n: dense_init(key, d, (d, d), dt, out.get(n))
         for n in ("wr", "wk", "wv", "wg", "wo", "cm_wr")}
    return {
        **mu, **w,
        "w0": _fill((d,), -0.6, F32, dev, out.get("w0")),
        "wA": dense_init(key, d, (d, _LORA), dt, out.get("wA")),
        "wB": dense_init(key, _LORA, (_LORA, d), dt, out.get("wB")),
        "u": _fill((H, hd), 0.0, F32, dev, out.get("u")),
        "ln_scale": _fill((d,), 1.0, F32, dev, out.get("ln_scale")),   # per-head group norm
        "cm_wk": dense_init(key, d, (d, dff), dt, out.get("cm_wk")),
        "cm_wv": dense_init(key, dff, (dff, d), dt, out.get("cm_wv")),
    }


def rwkv6_pspecs() -> dict:
    return {
        "mu_r": LP(None), "mu_k": LP(None), "mu_v": LP(None),
        "mu_w": LP(None), "mu_g": LP(None),
        "wr": LP("embed_fsdp", "heads_flat"), "wk": LP("embed_fsdp", "heads_flat"),
        "wv": LP("embed_fsdp", "heads_flat"), "wg": LP("embed_fsdp", "heads_flat"),
        "wo": LP("heads_flat", "embed_fsdp"),
        "w0": LP("heads_flat"), "wA": LP("embed_fsdp", None),
        "wB": LP(None, "heads_flat"),
        "u": LP("heads", None), "ln_scale": LP("heads_flat"),
        "cm_mu_k": LP(None), "cm_mu_r": LP(None),
        "cm_wk": LP("embed_fsdp", "ff"), "cm_wv": LP("ff", "embed_fsdp"),
        "cm_wr": LP("embed_fsdp", "heads_flat"),
    }


def _shift(x: torch.Tensor, prev: Optional[torch.Tensor]) -> torch.Tensor:
    """xx[t] = x[t-1]; position 0 takes ``prev`` (decode carry) or zeros."""
    first = prev[:, None, :] if prev is not None else torch.zeros_like(x[:, :1])
    return torch.cat([first, x[:, :-1]], dim=1)


def _headnorm(y: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    """GroupNorm with one group per head.  y: [B, S, H, hd]."""
    yf = y.to(F32)
    mean = yf.mean(dim=-1, keepdim=True)
    c = yf - mean
    var = (c * c).mean(dim=-1, keepdim=True)
    n = c * torch.rsqrt(var + eps)
    B, S, H, hd = y.shape
    return (n.reshape(B, S, H * hd) * scale).to(y.dtype)


def _mixer(x: torch.Tensor, xx: torch.Tensor):
    """mix(mu) = x + (xx - x) * mu, in x's dtype."""
    delta = xx - x
    return lambda mu: x + delta * mu[None, None, :].to(x.dtype)


def _logw(p: dict, mixed: torch.Tensor) -> torch.Tensor:
    """The data-dependent log decay, float32 and <= 0."""
    h = torch.tanh(mixed @ p["wA"])
    lora = constrain(h, "batch", *[None] * (h.dim() - 1)) @ p["wB"]
    return -torch.exp(torch.clamp(p["w0"] + lora.to(F32), -8.0, 2.0))


def _wkv(r, k, v, logw, u, s0, Lc: int):
    """The chunked WKV: r / k / v / logw [B, S, H, hd], u [H, hd], s0
    [B, H, hd, hd] float32 or None.  Returns (y [B, nc, Lc, H, hd] float32,
    the final state)."""
    B, S, H, hd = r.shape
    nc = S // Lc
    shp = (B, nc, Lc, H, hd)
    r_c = r.reshape(shp).to(F32)
    k_c = k.reshape(shp).to(F32)
    v_c = v.reshape(shp).to(F32)
    lw = logw.reshape(shp)
    cum = torch.cumsum(lw, dim=2)                     # [B,nc,Lc,H,hd]

    s = s0 if s0 is not None else torch.zeros((B, H, hd, hd), dtype=F32, device=r.device)
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=r.device), diagonal=-1)
    ys = []
    for c in range(nc):
        rr, kk, vv, cc, ww = (a[:, c] for a in (r_c, k_c, v_c, cum, lw))   # [B,Lc,H,hd]
        # intra-chunk strict-lower scores
        dec = torch.exp(cc[:, :, None] - ww[:, :, None] - cc[:, None, :])
        dec = torch.where(tri[None, :, :, None, None], dec, 0.0)
        scores = torch.einsum("bthd,btshd,bshd->btsh", rr, dec, kk)
        y = torch.einsum("btsh,bshp->bthp", scores, vv)
        # diagonal bonus term
        y = y + torch.einsum("bthd,hd,bthd,bthp->bthp", rr, u, kk, vv)
        # inter-chunk from the carried state
        rdec = rr * torch.exp(cc - ww)
        y = y + torch.einsum("bthd,bhdp->bthp", rdec, s)
        # state update (all factors <= 1)
        last = cc[:, -1:, :, :]
        kdec = kk * torch.exp(last - cc)
        s = s * torch.exp(last[:, 0])[..., None] + torch.einsum("bthd,bthp->bhdp", kdec, vv)
        ys.append(y)
    return torch.stack(ys, dim=1), s


def _wkv_local(r, k, v, logw, u, s0, Lc: int):
    """``_wkv`` of DTensors on each rank's local shards (the body of a
    ``local_map``), batch rows and heads as the projections shard them:
    the WKV recurrence is independent across both."""
    r = constrain(r, "batch", "seq", "heads", None)
    mesh, pl = r.device_mesh, r.placements
    if any(isinstance(q, Shard) and q.dim in (1, 3) for q in pl):
        raise ValueError(f"the WKV over a sharded sequence or head dim: {pl}")

    def like(on_b, on_h):
        return tuple(on_b if q == Shard(0) else on_h if q == Shard(2) else Replicate()
                     for q in pl)

    def local(t, want):
        return t.redistribute(mesh, want).to_local(grad_placements=want)

    y, s = _wkv(local(r, pl), local(k, pl), local(v, pl), local(logw, pl),
                local(u, like(Replicate(), Shard(0))),
                None if s0 is None else local(s0, like(Shard(0), Shard(1))), Lc)
    return (DTensor.from_local(y, mesh, like(Shard(0), Shard(3)), run_check=False),
            DTensor.from_local(s, mesh, like(Shard(0), Shard(1)), run_check=False))


def rwkv6_time_mix(p: dict, cfg, x: torch.Tensor, *, chunk: int = 64,
                   state: Optional[RWKVState] = None, return_state: bool = False):
    """x: [B, S, D] -> [B, S, D] (and the final RWKVState if asked)."""
    B, S, D = x.shape
    H = cfg.n_heads
    hd = D // H
    Lc = min(chunk, S)
    if S % Lc:
        raise ValueError(f"chunk {Lc} does not divide S={S}")
    x = constrain(x, "batch", "seq", None)       # whole on every model rank

    mix = _mixer(x, _shift(x, state.shift_att if state is not None else None))
    r = mix(p["mu_r"]) @ p["wr"]
    k = mix(p["mu_k"]) @ p["wk"]
    v = mix(p["mu_v"]) @ p["wv"]
    g = mix(p["mu_g"]) @ p["wg"]
    logw = _logw(p, mix(p["mu_w"]))

    r, k, v, logw = (t.reshape(B, S, H, hd) for t in (r, k, v, logw))
    s0 = state.wkv if state is not None else None
    wkv = _wkv_local if isinstance(r, DTensor) else _wkv
    y, s = wkv(r, k, v, logw, p["u"], s0, Lc)
    y = constrain(y.reshape(B, S, H, hd).to(x.dtype), "batch", "seq", "heads", None)

    out = _headnorm(y, p["ln_scale"], cfg.norm_eps)
    out = out * _silu_as(g, x.dtype)
    out = out @ p["wo"]
    if return_state:
        return out, RWKVState(wkv=s, shift_att=x[:, -1, :],
                              shift_ffn=torch.zeros_like(x[:, -1, :]))
    return out


def _wkv_step(r, k, v, logw, u, s):
    """One token's WKV: r / k / v / logw [B, H, hd], u [H, hd], s
    [B, H, hd, hd] float32.  Returns (y [B, H, hd] float32, the new s)."""
    rh, kh, vh = r.to(F32), k.to(F32), v.to(F32)
    w = torch.exp(logw)
    kv = torch.einsum("bhd,bhp->bhdp", kh, vh)
    y = torch.einsum("bhd,bhdp->bhp", rh * u[None], kv) + \
        torch.einsum("bhd,bhdp->bhp", rh, s)
    return y, s * w[..., None] + kv


def _wkv_step_local(r, k, v, logw, u, s):
    """``_wkv_step`` of DTensors on each rank's local shards: batch rows
    and heads, as the state's spec (batch, heads) shards them."""
    r = constrain(r, "batch", "heads", None)
    mesh, pl = r.device_mesh, r.placements

    def like(on_b, on_h):
        return tuple(on_b if q == Shard(0) else on_h if q == Shard(1) else Replicate()
                     for q in pl)

    def local(t, want):
        return t.redistribute(mesh, want).to_local()

    y, s_new = _wkv_step(local(r, pl), local(k, pl), local(v, pl), local(logw, pl),
                         local(u, like(Replicate(), Shard(0))), local(s, pl))
    return (DTensor.from_local(y, mesh, pl, run_check=False),
            DTensor.from_local(s_new, mesh, pl, run_check=False))


def rwkv6_time_mix_decode(p: dict, cfg, x: torch.Tensor, state: RWKVState):
    """One-token decode.  x: [B, 1, D]; O(1) in context."""
    B, _, D = x.shape
    H = cfg.n_heads
    hd = D // H

    mix = _mixer(x, state.shift_att[:, None, :])
    r = (mix(p["mu_r"]) @ p["wr"])[:, 0]
    k = (mix(p["mu_k"]) @ p["wk"])[:, 0]
    v = (mix(p["mu_v"]) @ p["wv"])[:, 0]
    g = (mix(p["mu_g"]) @ p["wg"])[:, 0]
    logw = _logw(p, mix(p["mu_w"])[:, 0])

    r, k, v, logw = (t.reshape(B, H, hd) for t in (r, k, v, logw))
    step = _wkv_step_local if isinstance(r, DTensor) else _wkv_step
    y, s_new = step(r, k, v, logw, p["u"], state.wkv)

    y = y.reshape(B, 1, H, hd).to(x.dtype)
    out = _headnorm(y, p["ln_scale"], cfg.norm_eps)
    out = out * _silu_as(g, x.dtype)[:, None, :]
    out = out @ p["wo"]
    return out, state._replace(wkv=s_new, shift_att=x[:, 0, :])


def rwkv6_channel_mix(p: dict, x: torch.Tensor, prev: Optional[torch.Tensor] = None,
                      return_shift: bool = False):
    """x: [B, S, D] -> [B, S, D] (and the last token, the next shift, if
    asked)."""
    x = constrain(x, "batch", "seq", None)       # whole on every model rank
    mix = _mixer(x, _shift(x, prev))
    k = mix(p["cm_mu_k"]) @ p["cm_wk"]
    k = torch.square(torch.relu(k.to(F32))).to(x.dtype)
    k = constrain(k, "batch", "seq", "ff")
    kv = k @ p["cm_wv"]
    r = torch.sigmoid((mix(p["cm_mu_r"]) @ p["cm_wr"]).to(F32)).to(x.dtype)
    out = r * kv
    if return_shift:
        return out, x[:, -1, :]
    return out


def init_rwkv_state(cfg, B: int, dtype, *, device=None) -> RWKVState:
    """Zero float32 WKV state and zero shifts in ``dtype``, on ``device``
    (the card unless named)."""
    device = resolve_device(device)
    H = cfg.n_heads
    hd = cfg.d_model // H
    return RWKVState(
        wkv=torch.zeros((B, H, hd, hd), dtype=F32, device=device),
        shift_att=torch.zeros((B, cfg.d_model), dtype=dtype, device=device),
        shift_ffn=torch.zeros((B, cfg.d_model), dtype=dtype, device=device))


def rwkv_state_pspecs():
    return RWKVState(wkv=LP("batch", "heads", None, None),
                     shift_att=LP("batch", None),
                     shift_ffn=LP("batch", None))
