"""Transformer layers of the decode path: RMSNorm, RoPE, GQA attention
against a KV cache, SwiGLU MLP, embeddings and logits.

PyTorch mirror of the decode subset of ``repro.models.layers``.  Params are
plain nested dicts of tensors stored in ``cfg.dtype``; the reference's
float32 islands are kept at the same points (norm statistics, RoPE, the
attention scores and softmax, SiLU), with a cast back to the activations'
dtype after each.  The matrix products are ``torch.matmul`` on the
weights' own layout ([d, H, hd] and friends, flattened to 2-D views).

The reference's ``constrain`` is a sharding annotation with nothing to do
on one device, so it has no counterpart here; the train / prefill path
(``attention_fwd``, ``flash_attention``) is not ported yet (ROADMAP A.8).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

F32 = torch.float32
_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def dtype_of(cfg) -> torch.dtype:
    """The torch dtype of ``cfg.dtype`` ("bfloat16" or "float32")."""
    try:
        return _DTYPES[cfg.dtype]
    except KeyError:
        raise ValueError(f"unsupported dtype {cfg.dtype!r}") from None


def _init(gen: torch.Generator, shape, scale, dtype,
          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard normal truncated to [-2, 2] in float32, times ``scale``,
    cast to ``dtype``; drawn from ``gen`` on the generator's device.  With
    ``out`` (e.g. one layer's slice of a stacked tensor) the values are
    written into it and it is returned."""
    x = torch.empty(shape, dtype=F32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    x.mul_(scale)
    if out is None:
        return x.to(dtype)
    return out.copy_(x)


def dense_init(gen: torch.Generator, d_in: int, shape: tuple, dtype,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fan-in scaled truncated-normal init."""
    return _init(gen, shape, d_in ** -0.5, dtype, out)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_params(d: int, dtype, device=None) -> dict:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rmsnorm(p: dict, x: torch.Tensor, eps: float) -> torch.Tensor:
    xf = x.to(F32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * p["scale"]).to(x.dtype)        # the scale promotes to float32


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_tables(positions: torch.Tensor, hd: int, theta: float):
    """(cos, sin), each [B, S, 1, hd // 2] float32: the rotation angles at
    ``positions`` [B, S].  One table serves every layer of a step."""
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=F32, device=positions.device) / half)
    ang = positions[..., None].to(F32) * freqs              # [B, S, half]
    return torch.cos(ang)[:, :, None, :], torch.sin(ang)[:, :, None, :]


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
         tables: Optional[tuple] = None) -> torch.Tensor:
    """x: [B, S, H, hd]; positions: [B, S] (absolute).  Rotates the first
    half of the head dim against the second, in float32; ``tables`` are
    ``rope_tables(positions, hd, theta)`` when the caller has them."""
    cos, sin = tables if tables is not None else rope_tables(
        positions, x.shape[-1], theta)
    x1, x2 = torch.split(x, x.shape[-1] // 2, dim=-1)   # promote to float32
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# GQA attention, decode path
# ---------------------------------------------------------------------------


def head_mask(cfg, device=None) -> Optional[torch.Tensor]:
    """[padded_heads] 1/0 float32 mask (None when no padding).  Padded
    q-heads sit at the tail of each kv group, so q-head i keeps kv head
    i // padded_groups."""
    Hp, H = cfg.padded_heads, cfg.n_heads
    if Hp == H:
        return None
    h = torch.arange(Hp, device=device)
    Gp, G = cfg.padded_q_groups, cfg.q_groups
    if Gp != G:      # GQA: pad within each group
        return ((h % Gp) < G).to(F32)
    return (h < H).to(F32)   # MHA: pad q+kv together


def attention_params(gen: torch.Generator, cfg, d_model: Optional[int] = None,
                     out: Optional[dict] = None) -> dict:
    """wq [d, Hp, hd], wk / wv [d, Kvp, hd], wo [Hp, hd, d]; the padded
    heads' wq and wo are zero.  With ``out`` (a dict of tensors of those
    shapes, e.g. one layer's slices of the stacked params) the weights are
    written into it."""
    d = d_model or cfg.d_model
    hd = cfg.resolved_head_dim
    Hp, Kvp = cfg.padded_heads, cfg.padded_kv_heads
    dt = dtype_of(cfg)
    out = out or {}
    p = {
        "wq": dense_init(gen, d, (d, Hp, hd), dt, out.get("wq")),
        "wk": dense_init(gen, d, (d, Kvp, hd), dt, out.get("wk")),
        "wv": dense_init(gen, d, (d, Kvp, hd), dt, out.get("wv")),
        "wo": dense_init(gen, cfg.n_heads * hd, (Hp, hd, d), dt, out.get("wo")),
    }
    mask = head_mask(cfg, p["wq"].device)
    if mask is not None:   # zero the padded heads; the decode mask keeps them 0
        p["wq"].mul_(mask[None, :, None].to(dt))
        p["wo"].mul_(mask[:, None, None].to(dt))
    return p


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [B, S, d] times w [d, H, k] -> [B, S, H, k]."""
    return (x @ w.reshape(w.shape[0], -1)).reshape(
        *x.shape[:-1], *w.shape[1:])


class DecodeStep(NamedTuple):
    """What every layer of one decode step shares: the rows, positions
    [B] int64, the positions a row may attend (``drop`` [B, 1, 1, S] True
    past ``pos``), the RoPE tables and the padded-head mask (or None)."""
    rows: torch.Tensor
    pos: torch.Tensor
    drop: torch.Tensor
    tables: tuple
    heads: Optional[torch.Tensor]


def decode_step_consts(cfg, pos: torch.Tensor, S: int) -> DecodeStep:
    """The ``DecodeStep`` of a batch at ``pos`` [B] against an S-slot cache."""
    pos = pos.to(torch.int64)
    dev = pos.device
    drop = torch.arange(S, device=dev)[None, :] > pos[:, None]
    return DecodeStep(torch.arange(pos.shape[0], device=dev), pos,
                      drop[:, None, None, :],
                      rope_tables(pos[:, None], cfg.resolved_head_dim, cfg.rope_theta),
                      head_mask(cfg, dev))


def attend(p: dict, cfg, x: torch.Tensor, cache_k: torch.Tensor,
           cache_v: torch.Tensor, step: DecodeStep, *, use_rope: bool = True,
           append: bool = True) -> torch.Tensor:
    """``attention_decode`` with the step's shared tensors given, adding
    the new key and value into ``cache_k`` / ``cache_v`` in place (at each
    row's position: the reference's one-hot add).  Returns out [B, 1, D]."""
    B, S, Kv, hd = cache_k.shape
    G = cfg.padded_q_groups
    q = _proj(x, p["wq"])                               # [B, 1, Hp, hd]
    k_new = _proj(x, p["wk"])                           # [B, 1, Kv, hd]
    v_new = _proj(x, p["wv"])
    if use_rope:
        q = rope(q, None, cfg.rope_theta, step.tables)
        k_new = rope(k_new, None, cfg.rope_theta, step.tables)
    if append:          # one position a row: a gather, an add and a scatter
        cache_k[step.rows, step.pos] += k_new[:, 0].to(cache_k.dtype)
        cache_v[step.rows, step.pos] += v_new[:, 0].to(cache_v.dtype)
    qg = q.reshape(B, Kv, G, hd).to(F32)
    s = torch.einsum("bkgd,bskd->bkgs", qg, cache_k.to(F32)) * (hd ** -0.5)
    pw = torch.softmax(s.masked_fill(step.drop, float("-inf")), dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", pw, cache_v.to(F32))
    o = o.reshape(B, 1, Kv * G, hd).to(x.dtype)
    if step.heads is not None:
        o = o * step.heads[None, None, :, None].to(o.dtype)
    wo = p["wo"]
    return o.reshape(B, 1, -1) @ wo.reshape(-1, wo.shape[-1])


def attention_decode(p: dict, cfg, x: torch.Tensor, cache_k: torch.Tensor,
                     cache_v: torch.Tensor, pos: torch.Tensor, *,
                     use_rope: bool = True, append: bool = True):
    """Decode path: x [B, 1, D]; cache_k/v [B, S, Kv, hd]; pos [B] int.

    Grouped-query attention directly against the cache (no KV repeat).
    With ``append`` the new key and value are added at ``pos`` into new
    cache tensors (the inputs are left as they are).  Returns (out
    [B, 1, D], cache_k', cache_v')."""
    if append:
        cache_k, cache_v = cache_k.clone(), cache_v.clone()
    step = decode_step_consts(cfg, pos, cache_k.shape[1])
    out = attend(p, cfg, x, cache_k, cache_v, step, use_rope=use_rope, append=append)
    return out, cache_k, cache_v


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------


def mlp_params(gen: torch.Generator, d: int, d_ff: int, dtype,
               out: Optional[dict] = None) -> dict:
    out = out or {}
    return {
        "w1": dense_init(gen, d, (d, d_ff), dtype, out.get("w1")),
        "w3": dense_init(gen, d, (d, d_ff), dtype, out.get("w3")),
        "w2": dense_init(gen, d_ff, (d_ff, d), dtype, out.get("w2")),
    }


def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ p["w1"]
    u = x @ p["w3"]
    h = torch.nn.functional.silu(g.to(F32)).to(x.dtype) * u
    return h @ p["w2"]


# ---------------------------------------------------------------------------
# Embedding / logits
# ---------------------------------------------------------------------------


def embed_params(gen: torch.Generator, cfg) -> dict:
    """tok [padded_vocab, d] and, unless tied, head [d, padded_vocab]."""
    V = cfg.padded_vocab
    dt = dtype_of(cfg)
    p = {"tok": _init(gen, (V, cfg.d_model), 1.0, dt)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(gen, cfg.d_model, (cfg.d_model, V), dt)
    return p


def embed_lookup(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    return p["tok"][tokens.to(torch.int64)]


def logits_fn(p: dict, x: torch.Tensor) -> torch.Tensor:
    """x [B, S, D] -> [B, S, V] in the weights' dtype."""
    w = p["tok"].T if "head" not in p else p["head"]
    return x @ w
