"""Pipeline parallelism over a mesh axis (GPipe, PyTorch mirror of
``repro.train.pipeline``).

The layer stack is SPLIT across the ranks of ``axis`` (each stage holds
n_layers / n_stages consecutive layers) and microbatches stream through:
stage s, step t processes microbatch (t - s); activations hop one stage a
step by send / recv over the axis's process group.  Total steps = n_micro
+ n_stages - 1; bubble fraction = (n_stages - 1) / (n_micro + n_stages - 1).

The forward pipeline only, as in the reference; it is exact: the
pipelined forward equals the sequential loop over the layers.  Every rank
returns the whole batch's output, which the last stage banked and a masked
all-reduce (a sum of it and zeros) spreads over the axis.
"""
from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .. import pytree


def pipeline_forward(layer_fn: Callable, stacked_params, x: torch.Tensor,
                     *, mesh, axis: str = "pod", n_micro: int = 4):
    """Run x through a layer stack split across ``axis``; call on every
    rank of ``mesh``.

    layer_fn(params_slice, h) -> h          (one layer)
    stacked_params: tree of tensors with leading dim n_layers (divisible by
        n_stages): the full stack on every rank (each takes its stage's
        layers), or DTensors sharded over ``axis`` on dim 0 (each rank's
        local layers are its stage's)
    x: [B, ...] activations (B divisible by n_micro), the same on every rank

    Returns the same result as looping layer_fn over all layers.
    """
    group = mesh.get_group(axis)
    n_stages = dist.get_world_size(group)
    sid = mesh.get_local_rank(axis)
    leaves, unflatten = pytree.flatten(stacked_params)
    n_layers = leaves[0].shape[0]
    if n_layers % n_stages:
        raise ValueError(f"{n_layers} layers do not split into {n_stages} stages")
    per = n_layers // n_stages
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} does not split into {n_micro} microbatches")
    local = [t.to_local() if isinstance(t, DTensor) else t[sid * per:(sid + 1) * per]
             for t in leaves]
    layers = [unflatten([t[i] for t in local]) for i in range(per)]
    mb = x.reshape(n_micro, B // n_micro, *x.shape[1:])
    nxt = dist.get_global_rank(group, (sid + 1) % n_stages)
    prv = dist.get_global_rank(group, (sid - 1) % n_stages)

    out = torch.zeros_like(mb)
    buf = torch.zeros_like(mb[0])
    for t in range(n_micro + n_stages - 1):
        m = t - sid                      # this stage's microbatch at step t
        active = 0 <= m < n_micro
        res = torch.zeros_like(buf)
        if active:
            res = mb[m] if sid == 0 else buf
            for lp in layers:
                res = layer_fn(lp, res)
            if sid == n_stages - 1:
                out[m] = res             # the last stage banks it
        # hop the activation one stage on (the first stage receives nothing)
        ops = []
        if sid < n_stages - 1:
            ops.append(dist.P2POp(dist.isend, res.contiguous(), nxt, group))
        if sid > 0:
            buf = torch.empty_like(buf)
            ops.append(dist.P2POp(dist.irecv, buf, prv, group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
    if sid != n_stages - 1:
        out.zero_()
    dist.all_reduce(out, group=group)    # the masked sum: only the last stage's
    return out.reshape(B, *x.shape[1:])
