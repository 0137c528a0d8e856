"""Training step: LM loss, grad accumulation (with an optional
error-feedback int8 accumulator), AdamW update (PyTorch mirror of
``repro.train.train_step``).

Gradients come from ``torch.autograd.grad`` of ``loss_fn`` with respect to
the params, which the step takes as leaves that require grad (views of the
state's tensors: nothing is copied).  Microbatches run one after another in
a Python loop with a float32 accumulator (the reference's ``lax.scan``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .. import pytree
from ..models import chunked_softmax_xent, forward, init_params
from ..optim.adamw import AdamWConfig, OptState, apply_update, init_opt_state
from .compression import ef_decode, ef_encode

F32 = torch.float32

LB_COEF = 0.01      # MoE load-balance aux weight
Z_COEF = 1e-3       # router z-loss weight


class TrainState(NamedTuple):
    params: dict
    opt: OptState


def init_train_state(cfg, opt_cfg: AdamWConfig, key, *, device=None) -> TrainState:
    """Random params (``key``: a seed or a ``torch.Generator``, as
    ``models.init_params``) and zero optimizer state, on ``device`` (the
    card unless named)."""
    params = init_params(cfg, key, device=device)
    return TrainState(params=params, opt=init_opt_state(params, opt_cfg))


def loss_fn(params, cfg, batch, dispatch_groups: int = 1):
    h, aux = forward(params, cfg, batch, dispatch_groups=dispatch_groups)
    if cfg.family == "vlm":
        h = h[:, cfg.n_img_tokens:]          # loss over text positions only
    loss = chunked_softmax_xent(params["embed"], h, batch["labels"], cfg.vocab)
    total = loss + LB_COEF * aux["lb_loss"] + Z_COEF * aux["z_loss"]
    return total, {"loss": loss, **aux}


def _split_microbatches(batch: dict, n: int) -> list:
    """The batch's leading axis cut into ``n`` equal microbatches."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: x[i * (b // n):(i + 1) * (b // n)] for k, x in batch.items()}
            for i in range(n)]


def _on(batch: dict, device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``."""
    return {k: torch.as_tensor(x, device=device) for k, x in batch.items()}


def _grads(params, cfg, batch, dispatch_groups: int):
    """(grads in the params' dtypes, aux detached) of ``loss_fn``."""
    flat, unflatten = pytree.flatten(params)
    leaves = [p.detach().requires_grad_(True) for p in flat]
    total, aux = loss_fn(unflatten(leaves), cfg, batch, dispatch_groups)
    grads = torch.autograd.grad(total, leaves)
    return unflatten(list(grads)), {k: v.detach() for k, v in aux.items()}


def train_step(state: TrainState, batch: dict, *, cfg, opt_cfg: AdamWConfig,
               dispatch_groups: int = 1, microbatches: int = 1,
               grad_compress: bool = False, param_specs=None):
    """One optimizer step on the params' device; ``batch`` ({"tokens",
    "labels"} [B, S], numpy or tensors) is moved there.
    ``microbatches > 1`` accumulates gradients over sequential microbatches
    in float32; ``grad_compress`` then stores each microbatch's gradient in
    error-feedback int8, the residual carried into the next microbatch.
    ``param_specs`` (a sharding tree) is accepted and ignored: it waits for
    sharding (ROADMAP A.8.3)."""
    dev = pytree.leaves(state.params)[0].device
    batch = _on(batch, dev)
    if microbatches == 1:
        grads, aux = _grads(state.params, cfg, batch, dispatch_groups)
    else:
        acc = pytree.tree_map(lambda p: torch.zeros(p.shape, dtype=F32, device=dev),
                              state.params)
        res = pytree.tree_map(torch.zeros_like, acc) if grad_compress else None
        auxs = []
        for mb in _split_microbatches(batch, microbatches):
            g, aux = _grads(state.params, cfg, mb, dispatch_groups)
            if grad_compress:
                g = pytree.tree_map(lambda a, b: a + b, g, res)
                dec = pytree.tree_map(lambda x: ef_decode(ef_encode(x)), g)
                res = pytree.tree_map(lambda gg, d: gg - d, g, dec)
                g = dec
            # in place: the float32 accumulator is the step's largest buffer
            pytree.tree_map(lambda a, b: a.add_(b), acc, g)
            auxs.append(aux)
        grads = pytree.tree_map(lambda a: a.div_(microbatches), acc)
        aux = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}

    params, opt, metrics = apply_update(state.params, grads, state.opt, opt_cfg)
    metrics.update(aux)
    return TrainState(params=params, opt=opt), metrics
