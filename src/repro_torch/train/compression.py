"""Gradient compression (PyTorch mirror of ``repro.train.compression``).

1. ``ef_encode``/``ef_decode`` — error-feedback int8 block quantization of
   a gradient tensor, for train_step's microbatch accumulator: the
   quantization residual is carried into the next microbatch, so the bias
   vanishes over steps (Seide et al. / EF-SGD).

2. ``ring_allreduce_q8`` — a ring all-reduce whose wire format is int8
   (+ one float32 scale a chunk): reduce-scatter then all-gather, both
   phases sending int8 payloads to the next rank of a mesh axis's process
   group (``batch_isend_irecv``).  The reference's ring, step for step and
   add for add, with its arithmetic as XLA compiles it on the CPU (the
   scale's ``/ 127`` as a multiply by float32(1/127), each reduce-scatter
   add one fused multiply-add), so the sums are the reference's bit for
   bit.  The axis is looked up on the mesh made current by
   ``models.sharding.use_mesh``, as ``shard_map`` resolves its axis names.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..models.sharding import current_mesh

F32 = torch.float32
_BLOCK = 256


class EFQ(NamedTuple):
    q: torch.Tensor        # int8 blocks [n, _BLOCK]
    scale: torch.Tensor    # f32 [n, 1]
    shape: tuple = ()
    size: int = 0


def ef_encode(x: torch.Tensor) -> EFQ:
    flat = x.to(F32).reshape(-1)
    blocks = F.pad(flat, (0, (-flat.numel()) % _BLOCK)).reshape(-1, _BLOCK)
    s = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    q = torch.round(blocks / torch.clamp_min(s, 1e-20)).to(torch.int8)
    return EFQ(q=q, scale=s, shape=tuple(x.shape), size=x.numel())


def ef_decode(t: EFQ) -> torch.Tensor:
    flat = (t.q.to(F32) * t.scale).reshape(-1)
    return flat[: t.size].reshape(t.shape)


# ---------------------------------------------------------------------------
# int8-wire ring all-reduce over a mesh axis
# ---------------------------------------------------------------------------


_INV127 = float(np.float32(1.0) / np.float32(127.0))


def _q8(x: torch.Tensor):
    """(int8 codes, float32 scale [1]): the scale is max|x| times
    float32(1/127), the division by a constant that XLA compiles the
    reference's ``/ 127.0`` into."""
    s = x.abs().amax() * _INV127
    q = torch.round(x / torch.clamp_min(s, 1e-20)).to(torch.int8)
    return q, s.reshape(1)


def _fma(acc: torch.Tensor, q: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """acc + q * s rounded once to float32 (the fused multiply-add XLA
    makes of the reference's add; q * s is exact in float64)."""
    return (acc.double() + q.double() * s.double()).to(F32)


def _shift(group, payload: tuple, nxt: int, prv: int) -> list:
    """Send each tensor of ``payload`` to global rank ``nxt`` and receive
    its like from ``prv`` (the reference's ppermute one step round the
    ring)."""
    recv = [torch.empty_like(t) for t in payload]
    ops = [dist.P2POp(dist.isend, t, nxt, group) for t in payload] + \
          [dist.P2POp(dist.irecv, r, prv, group) for r in recv]
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    return recv


def ring_allreduce_q8(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """Sum ``x`` across ``axis_name`` with int8 wire format.

    Call on every rank of the current mesh (``use_mesh``) with ``x`` its
    local tensor.  Quantization applies to the partial sums exchanged
    between neighbours (ring reduce-scatter, then ring all-gather of the
    final chunks); only int8 payloads and float32 scales are sent.
    """
    mesh = current_mesh()
    group = mesh.get_group(axis_name)
    n = dist.get_world_size(group)
    if n == 1:
        return x
    idx = mesh.get_local_rank(axis_name)
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    size = x.numel()
    flat = F.pad(x.to(F32).reshape(-1), (0, (-size) % n)).reshape(n, -1).clone()

    for k in range(n - 1):               # reduce-scatter
        q_r, s_r = _shift(group, _q8(flat[(idx - k) % n]), nxt, prv)
        r = (idx - k - 1) % n
        flat[r] = _fma(flat[r], q_r, s_r)
    # each rank now owns the fully-reduced chunk (idx + 1) % n
    for k in range(n - 1):               # all-gather
        q_r, s_r = _shift(group, _q8(flat[(idx + 1 - k) % n]), nxt, prv)
        flat[(idx - k) % n] = q_r.to(F32) * s_r
    return flat.reshape(-1)[:size].reshape(x.shape).to(x.dtype)
