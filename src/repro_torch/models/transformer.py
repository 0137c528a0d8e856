"""Model assembler: every architecture family of ``configs`` (``dense``,
``moe``, ``vlm``, ``encdec``, ``hybrid``, ``ssm``), with stacked layers and
decode caches (PyTorch mirror of ``repro.models.transformer``):

  init_params(cfg, key, *, device=None)      -> params (nested dict)
  forward(params, cfg, batch)                -> (final hidden [B,S,D], aux)
  init_cache(cfg, B, S, *, device=None)      -> Cache
  decode_step(params, cfg, cache, tokens, pos, dispatch_groups=1)
                                             -> (hidden [B,1,D], cache')

``batch`` is a dict of tensors: tokens [B,S] always; "img_embeds"
[B,Nimg,D] for vlm (prepended to the token stream); "enc_embeds" [B,Se,D]
for encdec (the encoder's input).  Layer parameters stay stacked
``[L, ...]`` as in the reference (hybrid's mamba layers ``[groups,
attn_every, ...]``), and ``forward`` / ``decode_step`` loop over the
leading axes (the reference scans them), with the positions and RoPE
tables made once for all layers.  With ``cfg.remat`` each layer (each
hybrid group) of ``forward`` runs under ``torch.utils.checkpoint`` (the
reference's ``jax.checkpoint``): the backward recomputes it from its
input.  The sharding specs wait for ROADMAP A.8.3.
"""
from __future__ import annotations

import itertools
from typing import NamedTuple, Union

import torch
# torch.utils.checkpoint imports torch._dynamo on its first call, and that
# import keeps its callers' frames alive for the life of the process: the
# first train step's whole state with them (measured: 39.6 GiB left
# allocated on the card at llama3-8b width, 4 layers).  Imported here, it
# holds only import-time frames.
import torch._dynamo  # noqa: F401
import torch.utils.checkpoint

from .. import pytree
from ..core.simulator import resolve_device
from . import rwkv as rk
from . import ssm
from .layers import (F32, attend, attention_fwd, attention_params,
                     decode_step_consts, dtype_of, embed_lookup, embed_params,
                     mlp, mlp_params, rmsnorm, rmsnorm_params, rope_tables)
from .moe import moe_apply, moe_params


def _generator(key: Union[int, torch.Generator], device) -> torch.Generator:
    """A generator from a seed on the resolved device, or ``key`` itself,
    which must then be on ``device`` when one is named."""
    if isinstance(key, torch.Generator):
        if device is not None and torch.device(device).type != key.device.type:
            raise ValueError(f"generator on {key.device}, device={device}")
        return key
    gen = torch.Generator(device=resolve_device(device))
    gen.manual_seed(int(key))
    return gen


def _stack(dims: tuple, draw):
    """Leaves stacked ``[*dims, ...]`` of ``draw(out)``, one layer's
    parameters (``out``: None, or a tree of tensors to write them into).
    Layers are drawn one after another, each into its slice of the
    stacked tensors, so the largest temporary is one layer."""
    first = draw(None)
    stacked = pytree.tree_map(lambda t: t.new_empty(dims + tuple(t.shape)), first)
    for n, i in enumerate(itertools.product(*(range(d) for d in dims))):
        view = pytree.tree_map(lambda s: s[i], stacked)
        if n == 0:
            pytree.tree_map(lambda s, t: s.copy_(t), view, first)
            del first
        else:
            draw(view)
    return stacked


def _unstack(tree, n: int) -> list:
    """``n`` trees of views, the i-th holding every leaf's ``[i]`` slice
    (one unbind a leaf)."""
    leaves, unflatten = pytree.flatten(tree)
    per = [t.unbind(0) for t in leaves]
    return [unflatten([p[i] for p in per]) for i in range(n)]


# ---------------------------------------------------------------------------
# per-family layer parameters (each written into ``out`` when given)
# ---------------------------------------------------------------------------


def _norm(cfg, dev, out):
    return rmsnorm_params(cfg.d_model, dtype_of(cfg), dev, out)


def _decoder_layer_params(gen, cfg, moe: bool, out=None) -> dict:
    out = out or {}
    p = {"ln1": _norm(cfg, gen.device, out.get("ln1")),
         "attn": attention_params(gen, cfg, out=out.get("attn")),
         "ln2": _norm(cfg, gen.device, out.get("ln2"))}
    if moe:
        p["moe"] = moe_params(gen, cfg, out.get("moe"))
    else:
        p["mlp"] = mlp_params(gen, cfg.d_model, cfg.d_ff, dtype_of(cfg), out.get("mlp"))
    return p


def _encdec_layer_params(gen, cfg, cross: bool, out=None) -> dict:
    out = out or {}
    p = {"ln1": _norm(cfg, gen.device, out.get("ln1")),
         "attn": attention_params(gen, cfg, out=out.get("attn")),
         "ln3": _norm(cfg, gen.device, out.get("ln3")),
         "mlp": mlp_params(gen, cfg.d_model, cfg.d_ff, dtype_of(cfg), out.get("mlp"))}
    if cross:
        p["ln2"] = _norm(cfg, gen.device, out.get("ln2"))
        p["xattn"] = attention_params(gen, cfg, out=out.get("xattn"))
    return p


def _rwkv_layer_params(gen, cfg, out=None) -> dict:
    out = out or {}
    return {"ln1": _norm(cfg, gen.device, out.get("ln1")),
            "ln2": _norm(cfg, gen.device, out.get("ln2")),
            "mix": rk.rwkv6_params(gen, cfg, out.get("mix"))}


def _mamba_layer_params(gen, cfg, out=None) -> dict:
    out = out or {}
    return {"ln": _norm(cfg, gen.device, out.get("ln")),
            "mamba": ssm.mamba2_params(gen, cfg, out.get("mamba"))}


def init_params(cfg, key: Union[int, torch.Generator], *, device=None) -> dict:
    """Random parameters: ``key`` is a seed (drawn on ``device``, the card
    unless named) or a ``torch.Generator`` (drawn on its device).  Each
    tensor is drawn on the device in float32 and cast, one layer slice at
    a time, so the largest float32 temporary is one embedding table or one
    layer's expert weights."""
    gen = _generator(key, device)
    fam = cfg.family
    params = {"embed": embed_params(gen, cfg),
              "final_ln": rmsnorm_params(cfg.d_model, dtype_of(cfg), gen.device)}
    if fam in ("dense", "vlm", "moe"):
        params["layers"] = _stack(
            (cfg.n_layers,), lambda o: _decoder_layer_params(gen, cfg, fam == "moe", o))
    elif fam == "encdec":
        params["enc_layers"] = _stack(
            (cfg.n_enc_layers,), lambda o: _encdec_layer_params(gen, cfg, False, o))
        params["dec_layers"] = _stack(
            (cfg.n_layers,), lambda o: _encdec_layer_params(gen, cfg, True, o))
        params["enc_ln"] = rmsnorm_params(cfg.d_model, dtype_of(cfg), gen.device)
    elif fam == "hybrid":
        params["groups"] = _stack((cfg.n_layers // cfg.attn_every, cfg.attn_every),
                                  lambda o: _mamba_layer_params(gen, cfg, o))
        params["shared"] = _decoder_layer_params(gen, cfg, False)
    elif fam == "ssm":
        params["layers"] = _stack((cfg.n_layers,), lambda o: _rwkv_layer_params(gen, cfg, o))
    else:
        raise ValueError(fam)
    return params


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------


def _maybe_remat(fn, cfg):
    """``fn`` under activation checkpointing when ``cfg.remat`` is set."""
    if not cfg.remat:
        return fn
    return lambda *a: torch.utils.checkpoint.checkpoint(fn, *a, use_reentrant=False)


def _positions(B: int, S: int, cfg, device):
    """(positions [B, S], their RoPE tables)."""
    pos = torch.arange(S, device=device).expand(B, S)
    return pos, rope_tables(pos, cfg.resolved_head_dim, cfg.rope_theta)


def forward(params: dict, cfg, batch: dict, *, dispatch_groups: int = 1,
            collect_state: bool = False):
    """Returns (hidden [B, S, D], aux), on the params' device.  aux holds
    the MoE losses averaged over layers (zero for the other families);
    ``collect_state`` is read by no family, as in the reference."""
    fam = cfg.family
    x = embed_lookup(params["embed"], batch["tokens"])
    B = x.shape[0]
    zero = torch.zeros((), dtype=F32, device=x.device)
    lb = zl = zero
    if fam == "vlm":
        x = torch.cat([batch["img_embeds"].to(x.dtype), x], dim=1)
    positions, tables = _positions(B, x.shape[1], cfg, x.device)

    def attn_block(p, ln, h, causal=True):
        return attention_fwd(p, cfg, rmsnorm(ln, h, cfg.norm_eps), positions,
                             causal=causal, tables=tables)

    if fam in ("dense", "vlm", "moe"):
        def body(h, lp):
            h = h + attn_block(lp["attn"], lp["ln1"], h)
            hn = rmsnorm(lp["ln2"], h, cfg.norm_eps)
            if fam == "moe":
                f, mx = moe_apply(lp["moe"], cfg, hn, dispatch_groups)
                return h + f, mx["lb_loss"], mx["z_loss"]
            return h + mlp(lp["mlp"], hn), zero, zero

        layer = _maybe_remat(body, cfg)
        for lp in _unstack(params["layers"], cfg.n_layers):
            x, l, z = layer(x, lp)
            lb, zl = lb + l, zl + z
        lb, zl = lb / cfg.n_layers, zl / cfg.n_layers

    elif fam == "encdec":
        enc = batch["enc_embeds"].to(x.dtype)
        enc_pos, enc_tables = _positions(B, enc.shape[1], cfg, x.device)

        def enc_body(h, lp):
            h = h + attention_fwd(lp["attn"], cfg, rmsnorm(lp["ln1"], h, cfg.norm_eps),
                                  enc_pos, causal=False, tables=enc_tables)
            return h + mlp(lp["mlp"], rmsnorm(lp["ln3"], h, cfg.norm_eps))

        def dec_body(h, lp, enc):
            h = h + attn_block(lp["attn"], lp["ln1"], h)
            h = h + attention_fwd(lp["xattn"], cfg, rmsnorm(lp["ln2"], h, cfg.norm_eps),
                                  positions, causal=False, kv_override=(enc, enc_pos),
                                  tables=tables)
            return h + mlp(lp["mlp"], rmsnorm(lp["ln3"], h, cfg.norm_eps))

        layer = _maybe_remat(enc_body, cfg)
        for lp in _unstack(params["enc_layers"], cfg.n_enc_layers):
            enc = layer(enc, lp)
        enc = rmsnorm(params["enc_ln"], enc, cfg.norm_eps)
        layer = _maybe_remat(dec_body, cfg)
        for lp in _unstack(params["dec_layers"], cfg.n_layers):
            x = layer(x, lp, enc)

    elif fam == "hybrid":
        def group_body(h, gp, sp):
            for lp in _unstack(gp, cfg.attn_every):
                h = h + ssm.mamba2_fwd(lp["mamba"], cfg, rmsnorm(lp["ln"], h, cfg.norm_eps))
            h = h + attn_block(sp["attn"], sp["ln1"], h)
            return h + mlp(sp["mlp"], rmsnorm(sp["ln2"], h, cfg.norm_eps))

        layer = _maybe_remat(group_body, cfg)
        for gp in _unstack(params["groups"], cfg.n_layers // cfg.attn_every):
            x = layer(x, gp, params["shared"])

    elif fam == "ssm":
        def body(h, lp):
            h = h + rk.rwkv6_time_mix(lp["mix"], cfg, rmsnorm(lp["ln1"], h, cfg.norm_eps))
            return h + rk.rwkv6_channel_mix(lp["mix"], rmsnorm(lp["ln2"], h, cfg.norm_eps))

        layer = _maybe_remat(body, cfg)
        for lp in _unstack(params["layers"], cfg.n_layers):
            x = layer(x, lp)
    else:
        raise ValueError(fam)

    return rmsnorm(params["final_ln"], x, cfg.norm_eps), {"lb_loss": lb, "z_loss": zl}


# ---------------------------------------------------------------------------
# decode caches + one-token decode step
# ---------------------------------------------------------------------------


class Cache(NamedTuple):
    """Family-polymorphic decode cache; unused fields are empty tensors."""
    k: torch.Tensor            # attn KV: [L, B, S, Kv, hd]
    v: torch.Tensor
    xk: torch.Tensor           # encdec cross-attn K/V: [L, B, Se, Kv, hd]
    xv: torch.Tensor
    ssm_conv: torch.Tensor     # [L_or_groups..., B, k-1, conv_dim]
    ssm: torch.Tensor          # [L..., B, H, N, P]
    wkv: torch.Tensor          # [L, B, H, hd, hd]
    shift_att: torch.Tensor    # [L, B, D]
    shift_ffn: torch.Tensor    # [L, B, D]


def init_cache(cfg, B: int, S: int, *, device=None) -> Cache:
    """An all-zero cache of ``B`` rows and ``S`` positions on ``device``
    (the card unless named), with the reference's shapes and dtypes per
    family: the SSM and WKV states float32, the rest ``cfg.dtype``."""
    dev = resolve_device(device)
    dt = dtype_of(cfg)
    fam = cfg.family

    def z(shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    e = z((0,), F32)
    kv = (B, S, cfg.padded_kv_heads, cfg.resolved_head_dim)
    if fam in ("dense", "vlm", "moe"):
        shp = (cfg.n_layers,) + kv
        return Cache(z(shp), z(shp), e, e, e, e, e, e, e)
    if fam == "encdec":
        shp = (cfg.n_layers,) + kv             # encoder length == S cell-wise
        return Cache(z(shp), z(shp), z(shp), z(shp), e, e, e, e, e)
    if fam == "hybrid":
        ng = cfg.n_layers // cfg.attn_every
        st = ssm.init_ssm_state(cfg, B, dt, device="meta")
        lead = (ng, cfg.attn_every)
        return Cache(z((ng,) + kv), z((ng,) + kv), e, e,
                     z(lead + st.conv.shape), z(lead + st.ssm.shape, F32), e, e, e)
    if fam == "ssm":
        st = rk.init_rwkv_state(cfg, B, dt, device="meta")
        L = (cfg.n_layers,)
        return Cache(e, e, e, e, e, e, z(L + st.wkv.shape, F32),
                     z(L + st.shift_att.shape), z(L + st.shift_ffn.shape))
    raise ValueError(fam)


def decode_step(params: dict, cfg, cache: Cache, tokens: torch.Tensor,
                pos: torch.Tensor, dispatch_groups: int = 1):
    """One new token against a populated cache, on the params' device.

    tokens: [B, 1] int; pos: [B] int (index of the new token).
    Returns (hidden [B, 1, D], cache'); the input cache is left as it
    is."""
    fam = cfg.family
    x = embed_lookup(params["embed"], tokens)
    eps = cfg.norm_eps

    if fam in ("dense", "vlm", "moe"):
        k, v = cache.k.clone(), cache.v.clone()     # the new cache, filled in place
        step = decode_step_consts(cfg, pos, k.shape[2])
        for l, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            x = x + attend(lp["attn"], cfg, rmsnorm(lp["ln1"], x, eps), k[l], v[l], step)
            hn = rmsnorm(lp["ln2"], x, eps)
            x = x + (moe_apply(lp["moe"], cfg, hn, dispatch_groups)[0] if fam == "moe"
                     else mlp(lp["mlp"], hn))
        cache = cache._replace(k=k, v=v)

    elif fam == "encdec":
        k, v = cache.k.clone(), cache.v.clone()
        step = decode_step_consts(cfg, pos, k.shape[2])
        # cross-attention: read-only over the encoder cache, every position
        Se = cache.xk.shape[2]
        xstep = decode_step_consts(cfg, torch.full_like(pos, Se - 1), Se)
        for l, lp in enumerate(_unstack(params["dec_layers"], cfg.n_layers)):
            x = x + attend(lp["attn"], cfg, rmsnorm(lp["ln1"], x, eps), k[l], v[l], step)
            x = x + attend(lp["xattn"], cfg, rmsnorm(lp["ln2"], x, eps), cache.xk[l],
                           cache.xv[l], xstep, use_rope=False, append=False)
            x = x + mlp(lp["mlp"], rmsnorm(lp["ln3"], x, eps))
        cache = cache._replace(k=k, v=v)

    elif fam == "hybrid":
        sp = params["shared"]
        ng = cfg.n_layers // cfg.attn_every
        k, v = cache.k.clone(), cache.v.clone()
        step = decode_step_consts(cfg, pos, k.shape[2])
        convs, states = [], []
        for g, gp in enumerate(_unstack(params["groups"], ng)):
            for j, lp in enumerate(_unstack(gp, cfg.attn_every)):
                out, ns = ssm.mamba2_decode(
                    lp["mamba"], cfg, rmsnorm(lp["ln"], x, eps),
                    ssm.SSMState(cache.ssm_conv[g, j], cache.ssm[g, j]))
                x = x + out
                convs.append(ns.conv)
                states.append(ns.ssm)
            x = x + attend(sp["attn"], cfg, rmsnorm(sp["ln1"], x, eps), k[g], v[g], step)
            x = x + mlp(sp["mlp"], rmsnorm(sp["ln2"], x, eps))
        lead = (ng, cfg.attn_every)
        cache = cache._replace(
            ssm_conv=torch.stack(convs).reshape(lead + cache.ssm_conv.shape[2:]),
            ssm=torch.stack(states).reshape(lead + cache.ssm.shape[2:]), k=k, v=v)

    elif fam == "ssm":
        wkv, sa, sf = [], [], []
        for l, lp in enumerate(_unstack(params["layers"], cfg.n_layers)):
            st = rk.RWKVState(cache.wkv[l], cache.shift_att[l], cache.shift_ffn[l])
            t, st = rk.rwkv6_time_mix_decode(lp["mix"], cfg, rmsnorm(lp["ln1"], x, eps), st)
            x = x + t
            c, shift = rk.rwkv6_channel_mix(lp["mix"], rmsnorm(lp["ln2"], x, eps),
                                            prev=st.shift_ffn, return_shift=True)
            x = x + c
            wkv.append(st.wkv)
            sa.append(st.shift_att)
            sf.append(shift)
        cache = cache._replace(wkv=torch.stack(wkv), shift_att=torch.stack(sa),
                               shift_ffn=torch.stack(sf))
    else:
        raise ValueError(fam)

    return rmsnorm(params["final_ln"], x, eps), cache
