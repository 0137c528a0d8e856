"""Model assembler: parameters, the train / prefill forward, the KV cache
and one-token decode of the ``dense`` family (llama3-8b's).

PyTorch mirror of the ``dense`` subset of ``repro.models.transformer``:

  init_params(cfg, key, *, device=None)      -> params (nested dict)
  forward(params, cfg, batch)                -> (final hidden [B,S,D], aux)
  init_cache(cfg, B, S, *, device=None)      -> Cache
  decode_step(params, cfg, cache, tokens, pos) -> (hidden [B,1,D], cache')

Layer parameters stay stacked ``[L, ...]`` as in the reference, and
``forward`` / ``decode_step`` loop over the leading axis (the reference
scans it), with the positions and RoPE tables made once for all layers.
With ``cfg.remat`` each layer of ``forward`` runs under
``torch.utils.checkpoint`` (the reference's ``jax.checkpoint``): the
backward recomputes it from its input.
The other families (``moe``, ``vlm``, ``encdec``, ``hybrid``, ``ssm``) are
not ported yet: they raise ``NotImplementedError`` naming ROADMAP A.8.2;
the sharding specs wait for A.8.3.
"""
from __future__ import annotations

from typing import NamedTuple, Union

import torch
# torch.utils.checkpoint imports torch._dynamo on its first call, and that
# import keeps its callers' frames alive for the life of the process: the
# first train step's whole state with them (measured: 39.6 GiB left
# allocated on the card at llama3-8b width, 4 layers).  Imported here, it
# holds only import-time frames.
import torch._dynamo  # noqa: F401
import torch.utils.checkpoint

from ..core.simulator import resolve_device
from .layers import (F32, attend, attention_fwd, attention_params,
                     decode_step_consts, dtype_of, embed_lookup, embed_params,
                     mlp, mlp_params, rmsnorm, rmsnorm_params, rope_tables)

PORTED_FAMILIES = ("dense",)


def check_family(cfg) -> None:
    """Raise unless the port has ``cfg``'s family."""
    if cfg.family not in PORTED_FAMILIES:
        raise NotImplementedError(
            f"family {cfg.family!r} ({cfg.name}) is not ported yet "
            f"(ROADMAP A.8); the port runs {PORTED_FAMILIES}")


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


def _layer_views(params: dict, L: int) -> list:
    """Layer l's parameters as views of the stacked tensors (one unbind a
    tensor), one dict a layer."""
    per = {(part, n): t.unbind(0) for part, sub in params["layers"].items()
           for n, t in sub.items()}
    views = [{} for _ in range(L)]
    for (part, n), ts in per.items():
        for l in range(L):
            views[l].setdefault(part, {})[n] = ts[l]
    return views


def _maybe_remat(fn, cfg):
    """``fn`` under activation checkpointing when ``cfg.remat`` is set."""
    if not cfg.remat:
        return fn
    return lambda *a: torch.utils.checkpoint.checkpoint(fn, *a, use_reentrant=False)


def forward(params: dict, cfg, batch: dict, *, dispatch_groups: int = 1,
            collect_state: bool = False):
    """Returns (hidden [B, S, D], aux), on the params' device.  ``batch``
    holds ``tokens`` [B, S] int.  aux holds the MoE losses, zero for the
    ``dense`` family; ``dispatch_groups`` and ``collect_state`` are read by
    no ported family."""
    check_family(cfg)
    x = embed_lookup(params["embed"], batch["tokens"])
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    tables = rope_tables(positions, cfg.resolved_head_dim, cfg.rope_theta)

    def body(h, lp):
        a = attention_fwd(lp["attn"], cfg, rmsnorm(lp["ln1"], h, cfg.norm_eps),
                          positions, causal=True, tables=tables)
        h = h + a
        return h + mlp(lp["mlp"], rmsnorm(lp["ln2"], h, cfg.norm_eps))

    layer = _maybe_remat(body, cfg)
    for lp in _layer_views(params, cfg.n_layers):
        x = layer(x, lp)
    zero = torch.zeros((), dtype=F32, device=x.device)
    aux = {"lb_loss": zero / cfg.n_layers, "z_loss": zero / cfg.n_layers}
    return rmsnorm(params["final_ln"], x, cfg.norm_eps), aux


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
    for l, lp in enumerate(_layer_views(params, cfg.n_layers)):
        x = x + attend(lp["attn"], cfg, rmsnorm(lp["ln1"], x, cfg.norm_eps),
                       k[l], v[l], step)
        x = x + mlp(lp["mlp"], rmsnorm(lp["ln2"], x, cfg.norm_eps))
    return rmsnorm(params["final_ln"], x, cfg.norm_eps), cache._replace(k=k, v=v)
