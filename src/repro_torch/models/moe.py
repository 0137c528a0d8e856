"""Mixture-of-Experts FFN with group-local capacity dispatch (PyTorch mirror
of ``repro.models.moe``).

Tokens are reshaped to [G, T_local] (``dispatch_groups`` = G), the top-k
assignment is sorted within each group, and tokens beyond the per-group
per-expert capacity C = max(8, ceil(T_local * k * capacity_factor / E))
are dropped (GShard-style).  The router, its softmax, the Switch
load-balance loss and the z-loss are float32; the expert products run on
the dispatched ``[G, E, C, D]`` block (every expert, padded slots
included), and the combine is a gather through the inverse sort.

The reference writes its dispatch table with one scatter whose dropped
tokens (pos >= C) all land on slot ``e*C + C-1``, the slot of the kept
token at pos C-1, and XLA lets the last write win: wherever expert e
overflows, that slot holds the pad row and the token at pos C-1 loses
its contribution.  The port computes the same table without duplicate
writes (``_dispatch_table``), so it does not depend on a device's write
order.  Top-k takes the lower expert index first on equal
probabilities, and the sort is stable, as ``lax.top_k`` and
``jnp.argsort`` are.
"""
from __future__ import annotations

from typing import Optional

import torch

from .layers import F32, _silu_as, dense_init, dtype_of, mlp, mlp_params


def moe_params(key: torch.Generator, cfg, out: Optional[dict] = None) -> dict:
    """router [d, E] float32; w1 / w3 [E, d, f], w2 [E, f, d]; the shared
    experts' SwiGLU MLP of width ``n_shared_experts * moe_d_ff``.  Drawn
    from the generator ``key`` on its device; with ``out`` (one layer's
    slices of stacked tensors) written into it."""
    d, f, e = cfg.d_model, cfg.moe_d_ff, cfg.n_experts
    dt = dtype_of(cfg)
    out = out or {}
    p = {
        "router": dense_init(key, d, (d, e), F32, out.get("router")),
        "w1": dense_init(key, d, (e, d, f), dt, out.get("w1")),
        "w3": dense_init(key, d, (e, d, f), dt, out.get("w3")),
        "w2": dense_init(key, f, (e, f, d), dt, out.get("w2")),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_params(key, d, cfg.n_shared_experts * f, dt, out.get("shared"))
    return p


def _top_k(probs: torch.Tensor, k: int):
    """``lax.top_k``: the k largest along the last axis, the lower index
    first among equal values (a stable descending sort)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _dispatch_table(se: torch.Tensor, st: torch.Tensor, E: int, C: int, Tl: int):
    """The reference's dispatch table ``disp`` [G, E*C] (token index a
    slot, ``Tl`` = the pad row), ``keep`` / ``slot`` [G, Tl*K] of the
    sorted assignments and each expert's assignments ``count`` [G, E];
    the table is written without duplicate indices.

    se / st: the expert and token of each assignment, sorted by expert
    (stable).  pos = rank within its expert; kept iff pos < C.  The kept
    assignments own distinct slots; every expert with more than C
    assignments has its last slot set to the pad row, which is what the
    reference's last write (a dropped one) leaves there."""
    G, N = se.shape
    first = torch.searchsorted(se, se, side="left")
    pos = torch.arange(N, device=se.device)[None, :] - first
    keep = pos < C
    slot = se * C + torch.clamp_max(pos, C - 1)
    # kept assignments to their own slot, dropped ones to a spare column
    disp = torch.full((G, E * C + 1), Tl, dtype=torch.int64, device=se.device)
    disp.scatter_(1, torch.where(keep, slot, E * C), torch.where(keep, st, Tl))
    disp = disp[:, :E * C].reshape(G, E, C)
    experts = torch.arange(E, device=se.device).expand(G, E).contiguous()
    count = (torch.searchsorted(se, experts, side="right")
             - torch.searchsorted(se, experts, side="left"))
    disp[:, :, C - 1] = torch.where(count > C, Tl, disp[:, :, C - 1])
    return disp.reshape(G, E * C), keep, slot, count


def moe_apply(p: dict, cfg, x: torch.Tensor, dispatch_groups: int = 1):
    """x: [B, S, D] -> ([B, S, D], aux losses {lb_loss, z_loss}), on x's
    device."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.experts_per_token
    T = B * S
    G = min(dispatch_groups, T)
    Tl = T // G
    if T % G:
        raise ValueError(f"{T} tokens do not split into {G} dispatch groups")
    C = max(8, int(-(-Tl * K * cfg.capacity_factor // E)))
    dev = x.device
    xf = x.reshape(G, Tl, D)

    logits = xf.to(F32) @ p["router"]                           # [G, Tl, E]
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, K)                            # [G, Tl, K]
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    # --- group-local sort-based dispatch ---------------------------------
    e_flat = top_e.reshape(G, Tl * K)
    t_flat = torch.arange(Tl, device=dev).repeat_interleave(K).expand(G, Tl * K)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    se = torch.gather(e_flat, 1, order)
    st = torch.gather(t_flat, 1, order)
    disp, keep, slot, count = _dispatch_table(se, st, E, C, Tl)

    # aux losses (Switch LB + z-loss); the counts are exact in float32
    me = probs.mean(dim=(0, 1))                                 # [E]
    ce = count.sum(dim=0).to(F32) / (T * K)
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    rows = torch.arange(G, device=dev)[:, None]
    x_pad = torch.cat([xf, xf.new_zeros((G, 1, D))], dim=1)
    x_disp = x_pad[rows, disp].reshape(G, E, C, D)

    g = torch.einsum("gecd,edf->gecf", x_disp, p["w1"])
    u = torch.einsum("gecd,edf->gecf", x_disp, p["w3"])
    h = _silu_as(g, x.dtype) * u
    y = torch.einsum("gecf,efd->gecd", h, p["w2"])

    # --- combine as a gather through the inverse sort permutation ---------
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(Tl * K, device=dev).expand(G, Tl * K))
    slot_tok = torch.gather(torch.where(keep, slot, E * C), 1, inv)   # [G, Tl*K]
    y_pad = torch.cat([y.reshape(G, E * C, D), y.new_zeros((G, 1, D))], dim=1)
    contrib = y_pad[rows, slot_tok]
    out = (contrib.reshape(G, Tl, K, D).to(F32) * top_w[..., None]).sum(dim=2)
    out = out.to(x.dtype)

    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xf)
    return out.reshape(B, S, D), {"lb_loss": lb_loss, "z_loss": z_loss}
