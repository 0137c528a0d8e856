"""Transformer layers: RMSNorm, RoPE, GQA attention (the flash-chunked
train / prefill path and the decode path against a KV cache), SwiGLU MLP,
embeddings, logits and the chunked cross-entropy.

PyTorch mirror of ``repro.models.layers``.  Params are plain nested dicts
of tensors stored in ``cfg.dtype``; the reference's float32 islands are
kept at the same points (norm statistics, RoPE, the attention scores and
softmax, SiLU, the logsumexp), with a cast back to the activations' dtype
after each.  The matrix products are ``torch.matmul`` on the weights' own
layout ([d, H, hd] and friends, flattened to 2-D views).

``flash_attention`` is a ``torch.autograd.Function`` whose forward is the
reference's online-softmax block loop and whose backward is its
FlashAttention-2 recompute, block for block (``_fa_forward`` /
``_flash_bwd``).  The reference's ``constrain`` and ``*_pspecs`` are
sharding annotations with nothing to do on one device; they wait for
sharding (ROADMAP A.8.3).
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


def _fill(shape, value: float, dtype, device, out: Optional[torch.Tensor]):
    """A constant leaf, or ``out`` filled with it."""
    if out is None:
        return torch.full(shape, value, dtype=dtype, device=device)
    return out.fill_(value)


def _silu_as(x: torch.Tensor, dtype) -> torch.Tensor:
    """SiLU in float32, cast to ``dtype``."""
    return torch.nn.functional.silu(x.to(F32)).to(dtype)


def dense_init(gen: torch.Generator, d_in: int, shape: tuple, dtype,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Fan-in scaled truncated-normal init."""
    return _init(gen, shape, d_in ** -0.5, dtype, out)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_params(d: int, dtype, device=None, out: Optional[dict] = None) -> dict:
    """{"scale": ones [d]}; with ``out`` (one layer's slice of a stacked
    scale) written into it."""
    if out is not None:
        out["scale"].fill_(1.0)
        return out
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
# Flash-chunked attention (train / prefill)
# ---------------------------------------------------------------------------


def _to_blocks(x: torch.Tensor, n: int, blk: int) -> torch.Tensor:
    B, S, H, hd = x.shape
    return x.reshape(B, n, blk, H, hd).permute(1, 0, 3, 2, 4)  # [n,B,H,blk,hd]


def _from_blocks(x: torch.Tensor, S: int) -> torch.Tensor:
    n, B, H, blk, hd = x.shape
    return x.permute(1, 0, 3, 2, 4).reshape(B, S, H, hd)


def _causal_drop(qi: int, ki: int, q_block: int, kv_block: int, device):
    """[q_block, kv_block] True where query block qi may not see key block
    ki's position (the reference's ``~(qpos >= kpos)``)."""
    qpos = qi * q_block + torch.arange(q_block, device=device)
    kpos = ki * kv_block + torch.arange(kv_block, device=device)
    return qpos[:, None] < kpos[None, :]


def _fa_forward(q, k, v, causal: bool, q_block: int, kv_block: int):
    """Returns (out [B,Sq,H,hd] in q's dtype, lse [nq,B,H,q_block] float32).
    Every (q, kv) block pair is computed, masked ones included, in the
    reference's order: the kv blocks of one q block, one after another."""
    B, Sq, H, hd = q.shape
    nq, nk = Sq // q_block, k.shape[1] // kv_block
    scale = hd ** -0.5
    qb, kb, vb = (_to_blocks(q, nq, q_block), _to_blocks(k, nk, kv_block),
                  _to_blocks(v, nk, kv_block))
    ninf = float("-inf")
    outs, lses = [], []
    for qi in range(nq):
        qq = qb[qi].to(F32) * scale                          # [B, H, qb, hd]
        m = torch.full((B, H, q_block), ninf, dtype=F32, device=q.device)
        l = torch.zeros((B, H, q_block), dtype=F32, device=q.device)
        acc = torch.zeros((B, H, q_block, hd), dtype=F32, device=q.device)
        for ki in range(nk):
            s = qq @ kb[ki].to(F32).transpose(-1, -2)
            if causal:
                s = s.masked_fill(_causal_drop(qi, ki, q_block, kv_block, q.device), ninf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            safe_m = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - safe_m[..., None])
            corr = torch.where(torch.isfinite(m), torch.exp(m - safe_m), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + p @ vb[ki].to(F32)
            m = m_new
        l = torch.clamp_min(l, 1e-30)
        outs.append((acc / l[..., None]).to(q.dtype))
        lses.append(torch.where(torch.isfinite(m), m + torch.log(l), ninf))
    return _from_blocks(torch.stack(outs), Sq), torch.stack(lses)


def _flash_bwd(causal: bool, q_block: int, kv_block: int, res, do):
    """FlashAttention-2 backward: recompute p per (q, kv) block pair from
    the saved logsumexp; the forward kept only O(S*hd) residuals.  The kv
    blocks run in the outer loop, each carrying its own dk / dv, and one
    float32 dq accumulator collects every block's dq."""
    q, k, v, o, lse = res
    B, Sq, H, hd = q.shape
    Sk = k.shape[1]
    nq, nk = Sq // q_block, Sk // kv_block
    scale = hd ** -0.5
    qb = _to_blocks(q, nq, q_block).to(F32)              # [nq,B,H,qb,hd]
    kb = _to_blocks(k, nk, kv_block).to(F32)
    vb = _to_blocks(v, nk, kv_block).to(F32)
    dob = _to_blocks(do, nq, q_block).to(F32)
    Dd = (dob * _to_blocks(o, nq, q_block).to(F32)).sum(dim=-1)   # [nq,B,H,qb]
    safe_lse = torch.where(torch.isfinite(lse), lse, 0.0)
    dq = torch.zeros((nq, B, H, q_block, hd), dtype=F32, device=q.device)
    dk, dv = [], []
    for j in range(nk):
        kk, vv = kb[j], vb[j]
        dkj = torch.zeros((B, H, kv_block, hd), dtype=F32, device=q.device)
        dvj = torch.zeros_like(dkj)
        for i in range(nq):
            qq, doi = qb[i], dob[i]
            s = (qq * scale) @ kk.transpose(-1, -2)
            if causal:
                s = s.masked_fill(_causal_drop(i, j, q_block, kv_block, q.device),
                                  float("-inf"))
            p = torch.exp(s - safe_lse[i][..., None])         # masked -> 0
            dp = doi @ vv.transpose(-1, -2)
            ds = p * (dp - Dd[i][..., None]) * scale
            dq[i] += ds @ kk
            dkj = dkj + ds.transpose(-1, -2) @ qq
            dvj = dvj + p.transpose(-1, -2) @ doi
        dk.append(dkj)
        dv.append(dvj)
    return (_from_blocks(dq, Sq).to(q.dtype), _from_blocks(torch.stack(dk), Sk).to(k.dtype),
            _from_blocks(torch.stack(dv), Sk).to(v.dtype))


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: saves (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, q_block, kv_block):
        out, lse = _fa_forward(q, k, v, causal, q_block, kv_block)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.blocks = (causal, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, do):
        return (*_flash_bwd(*ctx.blocks, ctx.saved_tensors, do), None, None, None)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool, q_block: int, kv_block: int) -> torch.Tensor:
    """Online-softmax attention with a FlashAttention-2 style backward.
    q, k, v: [B, S, H, hd] (KV already repeated to H heads).  Activation
    residency is O(S*hd) (out + logsumexp); the backward recomputes the
    probability blocks.  The causal path still *computes* masked blocks,
    as the reference does."""
    Sq, Sk = q.shape[1], k.shape[1]
    q_block, kv_block = min(q_block, Sq), min(kv_block, Sk)
    if Sq % q_block or Sk % kv_block:
        raise ValueError(f"blocks ({q_block}, {kv_block}) do not divide "
                         f"the sequences ({Sq}, {Sk})")
    return _Flash.apply(q, k, v, causal, q_block, kv_block)


# ---------------------------------------------------------------------------
# GQA attention block (train / prefill and decode)
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


def _repeat_kv(x: torch.Tensor, groups: int) -> torch.Tensor:
    """[B, S, Kv, hd] -> [B, S, Kv*groups, hd]."""
    if groups == 1:
        return x
    B, S, Kv, hd = x.shape
    return x[:, :, :, None, :].expand(B, S, Kv, groups, hd).reshape(B, S, Kv * groups, hd)


def attention_fwd(p: dict, cfg, x: torch.Tensor, positions: torch.Tensor, *,
                  causal: bool = True, use_rope: bool = True,
                  kv_override: Optional[tuple] = None,
                  tables: Optional[tuple] = None) -> torch.Tensor:
    """Train/prefill path.  x: [B, S, D] -> [B, S, D].  kv_override feeds
    cross-attention (keys/values come from the encoder stream);
    ``tables`` are ``rope_tables(positions, ...)`` when the caller has
    them."""
    q = _proj(x, p["wq"])
    src = x if kv_override is None else kv_override[0]
    k = _proj(src, p["wk"])
    v = _proj(src, p["wv"])
    if use_rope:
        q = rope(q, positions, cfg.rope_theta, tables)
        if kv_override is None:
            k = rope(k, positions, cfg.rope_theta, tables)
        else:
            k = rope(k, kv_override[1], cfg.rope_theta)
    k = _repeat_kv(k, cfg.padded_q_groups)
    v = _repeat_kv(v, cfg.padded_q_groups)
    o = flash_attention(q, k, v, causal=causal, q_block=cfg.q_block,
                        kv_block=cfg.kv_block)
    mask = head_mask(cfg, o.device)
    if mask is not None:
        o = o * mask[None, None, :, None].to(o.dtype)
    wo = p["wo"]
    return o.reshape(*o.shape[:2], -1) @ wo.reshape(-1, wo.shape[-1])


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
    return (_silu_as(g, x.dtype) * u) @ p["w2"]


# ---------------------------------------------------------------------------
# Embedding / logits / loss
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


def chunked_softmax_xent(embed_p: dict, x: torch.Tensor, labels: torch.Tensor,
                         vocab: int, chunk: int = 256) -> torch.Tensor:
    """Mean cross-entropy, computing logits seq-chunk by seq-chunk so the
    [B, S, V] tensor never materializes at once in the forward (the
    float32 logits of each chunk stay for the backward, as in the
    reference's scan).  Labels >= ``vocab`` (padding) are masked out."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    if S % chunk:
        raise ValueError(f"chunk {chunk} does not divide S={S}")
    labels = labels.to(torch.int64)
    total = torch.zeros((), dtype=F32, device=x.device)
    for c in range(0, S, chunk):
        ll = labels[:, c:c + chunk]
        logits = logits_fn(embed_p, x[:, c:c + chunk]).to(F32)
        lse = torch.logsumexp(logits, dim=-1)
        # a padded label gathers an in-range logit that the mask drops
        gold = logits.gather(-1, ll.clamp(max=logits.shape[-1] - 1)[..., None])[..., 0]
        total = total + torch.where(ll < vocab, lse - gold, 0.0).sum()
    return total / (B * S)
