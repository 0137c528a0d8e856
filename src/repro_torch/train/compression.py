"""Gradient compression: error-feedback int8 block quantization of a
gradient tensor (PyTorch mirror of ``repro.train.compression``).

``ef_encode``/``ef_decode`` serve train_step's microbatch accumulator: the
quantization residual is carried into the next microbatch, so the bias
vanishes over steps (Seide et al. / EF-SGD).  The int8-wire ring
all-reduce ``ring_allreduce_q8`` needs a process group and waits for
sharding (ROADMAP A.8.3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

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


def ring_allreduce_q8(x: torch.Tensor, axis_name: str) -> torch.Tensor:
    """The int8-wire ring all-reduce across a mesh axis: not ported yet."""
    raise NotImplementedError(
        "ring_allreduce_q8 needs a process group: it waits for sharding "
        "and launch (ROADMAP A.8.3)")
