"""Classical balls-and-bins power-of-d experiment (paper §I).

PyTorch mirror of ``repro.core.ballsbins``.  Places n balls into n bins:
d=1 (uniform random) gives max load ~ log n / log log n; d>=2 (choose the
emptier of d sampled bins) gives ~ log log n / log d + O(1), the
exponential improvement that motivates the paper.  Plain PyTorch, one ball
at a time, as the reference's scan.
"""
from __future__ import annotations

import math

import torch

from .cluster import uniform_int
from .simulator import resolve_device


def place(cand: torch.Tensor, n: int) -> torch.Tensor:
    """int32 [n] bin loads after ball b joins the emptier of its candidate
    bins ``cand[b]`` ([balls, d] int), balls in order; ties go to the
    first candidate."""
    loads = torch.zeros(n, dtype=torch.int32, device=cand.device)
    cand = cand.to(torch.int64)
    for c in cand:
        loads[c[torch.argmin(loads[c])]] += 1
    return loads


def max_load(gen: torch.Generator, n: int, d: int, *, device=None) -> torch.Tensor:
    """Max bin load after n balls -> n bins with d choices (d >= 1).
    ``gen`` is a generator on ``device`` (the card unless "cpu")."""
    dev = resolve_device(device)
    return place(uniform_int(gen, (n, d), n, dev), n).max()


def theory_d1(n: int) -> float:
    """~ log n / log log n."""
    return math.log(n) / math.log(math.log(n))


def theory_d(n: int, d: int) -> float:
    """~ log log n / log d."""
    return math.log(math.log(n)) / math.log(d)
