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

With DTensor activations (a sharded step) the router, its softmax, top-k
and the aux losses are DTensor ops, and the dispatch (the sort, the
dispatch table, the gathers, the local experts' products and the
combine) runs on each rank's local shards, as the body of a
``local_map``: the token groups sharded over the batch axes, the experts
over the "expert" axes.  Each rank combines its own experts'
contributions, and one all-reduce over the expert axes sums them: the
expert-parallel combine that the reference's GSPMD lowering has.  The
expert weights' other dims are gathered for the block (ZeRO's per-layer
gather); where that gathers the moe_ff dim, which the reference keeps
sharded, ``sharding.note_gather("moe.weights_gathered")`` counts it.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from .layers import F32, _silu_as, dense_init, dtype_of, mlp, mlp_params, mlp_pspecs
from .sharding import P, _axes, constrain, even_spec, logical_pspec as LP, note_gather


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


def moe_pspecs(cfg) -> dict:
    p = {
        "router": LP("embed_fsdp", None),
        "w1": LP("expert", "embed_fsdp", "moe_ff"),
        "w3": LP("expert", "embed_fsdp", "moe_ff"),
        "w2": LP("expert", "moe_ff", "embed_fsdp"),
    }
    if cfg.n_shared_experts:
        p["shared"] = mlp_pspecs()
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


def _dispatch(xf: torch.Tensor, top_e: torch.Tensor, E: int, C: int):
    """(x_disp [G, E, C, D], slot_tok [G, Tl*K], count [G, E]): the
    group-local sort-based dispatch of the assignments ``top_e`` [G, Tl, K]
    (stable sort by expert; ``slot_tok`` is each (token, choice)'s slot in
    the dispatched block, ``E*C`` where it was dropped)."""
    G, Tl, D = xf.shape
    K = top_e.shape[-1]
    dev = xf.device
    e_flat = top_e.reshape(G, Tl * K)
    t_flat = torch.arange(Tl, device=dev).repeat_interleave(K).expand(G, Tl * K)
    order = torch.argsort(e_flat, dim=-1, stable=True)
    se = torch.gather(e_flat, 1, order)
    st = torch.gather(t_flat, 1, order)
    disp, keep, slot, count = _dispatch_table(se, st, E, C, Tl)
    rows = torch.arange(G, device=dev)[:, None]
    x_pad = torch.cat([xf, xf.new_zeros((G, 1, D))], dim=1)
    x_disp = x_pad[rows, disp].reshape(G, E, C, D)
    # the combine reads through the inverse sort permutation
    inv = torch.empty_like(order).scatter_(
        1, order, torch.arange(Tl * K, device=dev).expand(G, Tl * K))
    slot_tok = torch.gather(torch.where(keep, slot, E * C), 1, inv)   # [G, Tl*K]
    return x_disp, slot_tok, count


def _experts(p: dict, x_disp: torch.Tensor, dtype) -> torch.Tensor:
    g = torch.einsum("gecd,edf->gecf", x_disp, p["w1"])
    u = torch.einsum("gecd,edf->gecf", x_disp, p["w3"])
    h = _silu_as(g, dtype) * u
    return torch.einsum("gecf,efd->gecd", h, p["w2"])


def _combine(y: torch.Tensor, slot_tok: torch.Tensor, top_w: torch.Tensor) -> torch.Tensor:
    """float32 [G, Tl, D]: each token's K expert outputs (slot ``E*C``
    and beyond read zeros), weighted and summed."""
    G, E, C, D = y.shape
    Tl, K = top_w.shape[1:]
    rows = torch.arange(G, device=y.device)[:, None]
    y_pad = torch.cat([y.reshape(G, E * C, D), y.new_zeros((G, 1, D))], dim=1)
    contrib = y_pad[rows, slot_tok]
    return (contrib.reshape(G, Tl, K, D).to(F32) * top_w[..., None]).sum(dim=2)


def _sharded_dispatch(p: dict, x, top_w, top_e, E: int, G: int, C: int):
    """The dispatch, experts and combine on each rank's local shards
    (module docstring).  x [B, S, D], top_w / top_e [B, S, K] DTensors; a
    rank's rows are whole dispatch groups.  Returns (out float32 [B, S, D]
    replicated over the expert axes, count [G, E])."""
    mesh = x.device_mesh
    names = list(mesh.mesh_dim_names)
    sizes = dict(zip(names, tuple(mesh.shape)))
    B, S, D = x.shape
    g_spec = even_spec(LP("batch"), (math.gcd(G, B),), mesh) if G > 1 else P(None)
    e_spec = even_spec(LP("expert"), (E,), mesh)
    g_axes, e_axes = set(_axes(g_spec[0])), set(_axes(e_spec[0]))
    if g_axes & e_axes:
        raise ValueError(f"the expert axes {e_axes} also shard the token groups")

    def pl(on_g, on_e):
        return tuple(on_g if a in g_axes else on_e if a in e_axes else Replicate()
                     for a in names)

    tok_pl, tok_grad = pl(Shard(0), Replicate()), pl(Shard(0), Partial())
    w_pl, w_grad = pl(Replicate(), Shard(0)), pl(Partial(), Shard(0))
    ws = {}
    for k in ("w1", "w3", "w2"):
        w = p[k]
        ff_dim = 2 if k != "w2" else 1
        if any(isinstance(q, Shard) and q.dim == ff_dim for q in w.placements):
            note_gather("moe.weights_gathered")
        ws[k] = w.redistribute(mesh, w_pl).to_local(grad_placements=w_grad)
    xl = x.redistribute(mesh, tok_pl).to_local(grad_placements=tok_grad)
    wl = top_w.redistribute(mesh, tok_pl).to_local(grad_placements=tok_grad)
    el = top_e.redistribute(mesh, tok_pl).to_local()
    G_l = G // (B // xl.shape[0])                  # this rank's groups
    Tl = B * S // G

    E_l = ws["w1"].shape[0]
    coord, e_index = mesh.get_coordinate(), 0
    for i, a in enumerate(names):
        if a in e_axes:
            e_index = e_index * sizes[a] + coord[i]
    e0 = e_index * E_l
    x_disp, slot_tok, count = _dispatch(xl.reshape(G_l, Tl, D),
                                        el.reshape(G_l, Tl, -1), E, C)
    y = _experts(ws, x_disp[:, e0:e0 + E_l], x.dtype)
    local = slot_tok - e0 * C
    local = torch.where((local >= 0) & (local < E_l * C), local, E_l * C)
    out = _combine(y, local, wl.reshape(G_l, Tl, -1)).reshape(xl.shape)  # own experts
    out = DTensor.from_local(out, mesh, pl(Shard(0), Partial()), run_check=False)
    count = DTensor.from_local(count, mesh, tok_pl, run_check=False)
    return out.redistribute(mesh, tok_pl), count


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
    sharded = isinstance(x, DTensor)
    # sharded: the groups stay in [B, S] rows, whole groups a rank
    xf = constrain(x, "batch", None, None) if sharded else x.reshape(G, Tl, D)

    logits = xf.to(F32) @ p["router"]                 # [G, Tl, E] ([B, S, E])
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = _top_k(probs, K)
    top_w = top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)

    if sharded:
        out, count = _sharded_dispatch(p, xf, top_w, top_e, E, G, C)
    else:
        x_disp, slot_tok, count = _dispatch(xf, top_e, E, C)
        out = _combine(_experts(p, x_disp, x.dtype), slot_tok, top_w)

    # aux losses (Switch LB + z-loss); the counts are exact in float32
    me = probs.mean(dim=(0, 1))                                 # [E]
    ce = constrain(count.sum(dim=0).to(F32) / (T * K), None)   # summed over groups
    lb_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    out = out.to(x.dtype)
    if cfg.n_shared_experts:
        out = out + mlp(p["shared"], xf)
    return out.reshape(B, S, D), {"lb_loss": lb_loss, "z_loss": z_loss}
