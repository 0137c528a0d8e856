"""Model assembler, decode path: parameters, the KV cache and one-token
decode of the ``dense`` family (llama3-8b's).

PyTorch mirror of the decode subset of ``repro.models.transformer``:

  init_params(cfg, key, *, device=None)      -> params (nested dict)
  init_cache(cfg, B, S, *, device=None)      -> Cache
  decode_step(params, cfg, cache, tokens, pos) -> (hidden [B,1,D], cache')

Layer parameters stay stacked ``[L, ...]`` as in the reference, and
``decode_step`` loops over the leading axis (the reference scans it),
with the step's positions, mask and RoPE tables made once for all layers
and the new cache filled in place.
The other families (``moe``, ``vlm``, ``encdec``, ``hybrid``, ``ssm``),
``forward`` (train / prefill) and the sharding specs are not ported yet:
they raise ``NotImplementedError`` naming ROADMAP A.8.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch

from ..core.simulator import resolve_device
from .layers import (attend, attention_params, decode_step_consts, dtype_of,
                     embed_lookup, embed_params, mlp, mlp_params, rmsnorm,
                     rmsnorm_params)

PORTED_FAMILIES = ("dense",)


def check_family(cfg) -> None:
    """Raise unless the port has ``cfg``'s family."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP A.8); the port decodes {PORTED_FAMILIES}")


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


def _layer_shapes(cfg) -> dict:
    d, hd, f = cfg.d_model, cfg.resolved_head_dim, cfg.d_ff
    Hp, Kvp = cfg.padded_heads, cfg.padded_kv_heads
    return {"attn": {"wq": (d, Hp, hd), "wk": (d, Kvp, hd),
                     "wv": (d, Kvp, hd), "wo": (Hp, hd, d)},
            "mlp": {"w1": (d, f), "w3": (d, f), "w2": (f, d)}}


def init_params(cfg, key: Union[int, torch.Generator], *, device=None) -> dict:
    """Random parameters: ``key`` is a seed (drawn on ``device``, the card
    unless named) or a ``torch.Generator`` (drawn on its device).  Each
    tensor is drawn on the device in float32 and cast, one layer slice at
    a time, so the largest float32 temporary is one embedding table."""
    check_family(cfg)
    gen = _generator(key, device)
    dev, dt, L, d = gen.device, dtype_of(cfg), cfg.n_layers, cfg.d_model
    params = {"embed": embed_params(gen, cfg),
              "final_ln": rmsnorm_params(d, dt, dev)}
    layers = {"ln1": {"scale": torch.ones((L, d), dtype=dt, device=dev)},
              "ln2": {"scale": torch.ones((L, d), dtype=dt, device=dev)}}
    for part, shapes in _layer_shapes(cfg).items():
        layers[part] = {k: torch.empty((L,) + s, dtype=dt, device=dev)
                        for k, s in shapes.items()}
    for l in range(L):
        attention_params(gen, cfg, out={k: t[l] for k, t in layers["attn"].items()})
        mlp_params(gen, d, cfg.d_ff, dt,
                   out={k: t[l] for k, t in layers["mlp"].items()})
    params["layers"] = layers
    return params


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
    (the card unless named)."""
    check_family(cfg)
    dev = resolve_device(device)
    shp = (cfg.n_layers, B, S, cfg.padded_kv_heads, cfg.resolved_head_dim)
    e = torch.zeros((0,), dtype=torch.float32, device=dev)
    return Cache(torch.zeros(shp, dtype=dtype_of(cfg), device=dev),
                 torch.zeros(shp, dtype=dtype_of(cfg), device=dev),
                 e, e, e, e, e, e, e)


def decode_step(params: dict, cfg, cache: Cache, tokens: torch.Tensor,
                pos: torch.Tensor):
    """One new token against a populated cache, on the params' device.

    tokens: [B, 1] int; pos: [B] int (index of the new token).
    Returns (hidden [B, 1, D], cache')."""
    check_family(cfg)
    x = embed_lookup(params["embed"], tokens)
    k, v = cache.k.clone(), cache.v.clone()       # the new cache, filled in place
    step = decode_step_consts(cfg, pos, k.shape[2])
    # the layers' views, one unbind a stacked tensor
    per = {(part, n): t.unbind(0) for part, sub in params["layers"].items()
           for n, t in sub.items()}
    for l in range(cfg.n_layers):
        lp = {}
        for (part, n), views in per.items():
            lp.setdefault(part, {})[n] = views[l]
        x = x + attend(lp["attn"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps),
                       k[l], v[l], step)
        x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return rmsnorm(params["final_ln"], x, cfg.norm_eps), cache._replace(k=k, v=v)
