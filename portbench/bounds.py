"""The yardstick of the kernels' roofline shares: the card's published
peaks and the least time a call's work can take on it.

A frozen copy of the port's smoke-test arithmetic (``bound_ms`` and the
``route_commit`` bound), extended to a launch that routes N cells: each
input read once and each output written once, over the memory rate,
against the float32 operations over the float32 peak.  It counts the work
the slot needs from the launch's live arrivals (the benchmark's own replay
of the draws), whatever implements it, so a kernel that reads less does not
move the yardstick, and one that skips the arrival buffer's empty rows
still reads at most 100%.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates, at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12


def bound_s(nbytes, ops):
    """Least seconds of each launch: its bytes over the memory rate or its
    operations over the float32 peak, whichever takes longer."""
    return np.maximum(np.asarray(nbytes, np.float64) / HBM_BYTES_PER_S,
                      np.asarray(ops, np.float64) / F32_OPS_PER_S)


def route_commit(M: int, B: int, C: Optional[int], live) -> float:
    """Least seconds of a run of sequential-commit routing launches, one a
    slot, over cells of M servers with B arrival slots each.  ``live`` is
    [slots, cells]: the arrivals each cell routes in each slot.  A cell
    with none needs nothing.  Per cell that routes, a launch reads the int32
    [M, 3] queues and the [B] arrival mask and writes the queues, the
    float32 [M] workloads and three outputs (pick, class, score) per live
    arrival.  Full Balanced-Pandas (C None) scores every server per live
    arrival, by its int32 class row, and reads the [M] tie priority; Pod
    scores C candidates (index, validity and the int32 candidate classes,
    which every cell shares up to the widest cell's live rows).  The [3]
    float32 rates are read once.  Operations: the workloads (5 a server)
    and a multiply and an add a scored candidate."""
    live = np.asarray(live, np.int64)
    rows, cells = live.sum(axis=1), (live > 0).sum(axis=1)
    per_cell = 12 * M + B + 12 * M + 4 * M
    nbytes = cells * per_cell + 12 * rows + 12 * (cells > 0)
    if C is None:
        nbytes = nbytes + 4 * rows * M + cells * 4 * M
        cand = M
    else:
        nbytes = nbytes + 5 * rows * C + 4 * live.max(axis=1) * C
        cand = C
    return float(bound_s(nbytes, cells * 5 * M + 2 * rows * cand).sum())
