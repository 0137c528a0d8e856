"""Training step: LM loss, grad accumulation (with an optional
error-feedback int8 accumulator), AdamW update (PyTorch mirror of
``repro.train.train_step``).

Gradients come from ``torch.autograd.grad`` of ``loss_fn`` with respect to
the params, which the step takes as leaves that require grad (views of the
state's tensors: nothing is copied).  Microbatches run one after another in
a Python loop with a float32 accumulator (the reference's ``lax.scan``).

With DTensor params (a sharded state, ``launch.specs.shard_tree``) the
step is a DTensor program: each microbatch's gradients are redistributed
to ``param_specs`` (the reference's sharding constraint on them), or to
the params' own placements when no specs are given, before they are
accumulated and applied.  With plain tensors ``param_specs`` does nothing,
as the reference's constraint outside a mesh.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from torch.distributed.tensor import DTensor

from .. import pytree
from ..models import chunked_softmax_xent, forward, init_params
from ..models.sharding import P, constrain, is_sharded, sharded_region, to_spec
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
    """The batch's leading axis cut into ``n`` equal microbatches (a
    DTensor's cut taken back to the batch's spec)."""
    b = next(iter(batch.values())).shape[0]
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    return [{k: constrain(x[i * (b // n):(i + 1) * (b // n)], "batch",
                          *(None,) * (x.dim() - 1))
             for k, x in batch.items()} for i in range(n)]


def _on(batch: dict, device) -> dict:
    """The batch's arrays (numpy or tensors) as tensors on ``device``;
    DTensors stay where they are."""
    return {k: x if isinstance(x, DTensor) else torch.as_tensor(x, device=device)
            for k, x in batch.items()}


def _pin(grads, params, param_specs):
    """DTensor gradients at ``param_specs`` (or at their params'
    placements); plain ones as they are."""
    flat, unflatten = pytree.flatten(grads)
    if param_specs is not None:
        specs = pytree.leaves(param_specs, is_leaf=lambda x: isinstance(x, P))
        return unflatten([to_spec(g, s) for g, s in zip(flat, specs)])
    return unflatten([g.redistribute(g.device_mesh, p.placements) if isinstance(g, DTensor)
                      else g for g, p in zip(flat, pytree.leaves(params))])


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
    ``param_specs`` (a PartitionSpec tree matching params) pins DTensor
    gradients to the parameter sharding (module docstring)."""
    dev = pytree.leaves(state.params)[0].device
    batch = _on(batch, dev)
    sharded = is_sharded(pytree.leaves(state.params))
    if not sharded:
        param_specs = None

    with sharded_region(sharded):
        return _step(state, batch, cfg, opt_cfg, dispatch_groups, microbatches,
                     grad_compress, (lambda g: _pin(g, state.params, param_specs))
                     if sharded else (lambda g: g))


def _step(state, batch, cfg, opt_cfg, dispatch_groups, microbatches, grad_compress, pin):
    if microbatches == 1:
        grads, aux = _grads(state.params, cfg, batch, dispatch_groups)
        grads = pin(grads)
    else:
        acc = pytree.tree_map(lambda p: torch.zeros_like(p, dtype=F32), state.params)
        res = pytree.tree_map(torch.zeros_like, acc) if grad_compress else None
        auxs = []
        for mb in _split_microbatches(batch, microbatches):
            g, aux = _grads(state.params, cfg, mb, dispatch_groups)
            g = pin(g)
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
