"""Commit a routed arrival batch to the queues and refresh the workloads.

Port of ``repro.kernels.queue_update`` (the Pallas TPU kernel
``_kernel``).  On a CUDA tensor the wrapper launches the hand-written
kernel in ``csrc/snapshot_route.cu`` (sm_90a, built with nvcc and bound
with ctypes by ``build.py``); on a CPU tensor it runs the plain version
``ref.queue_update_ref``.  The two compute the same function, bit for bit:
the commit counts are exact integers, and both sum the workload in the
order ``(q0*i0 + q1*i1) + q2*i2``.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .invrates import LAUNCHES, check, check_inv_rates, use_kernel
from .ref import queue_update_ref

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _fn():
    """The kernel's C entry point with its signature declared."""
    fn = build.load("snapshot_route").queue_update
    fn.argtypes = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P]
    fn.restype = _I
    return fn


def queue_update(Q: torch.Tensor, sel: torch.Tensor, sel_cls: torch.Tensor,
                 valid: torch.Tensor, inv_rates: torch.Tensor):
    """``Q[sel, sel_cls] += valid`` for the batch, then W from the new Q.

    Q: [M, 3] int32; sel/sel_cls: [B] int32; valid: [B] bool; inv_rates:
    [3] or [M, 3] float32.  An arrival whose server is outside 0..M-1 or
    whose class is outside 0..2 is dropped.  Returns (Q_new [M, 3] int32,
    W [M] float32), as ``ref.queue_update_ref``.
    """
    if not use_kernel(Q, "queue_update"):
        return queue_update_ref(Q, sel, sel_cls, valid, inv_rates)
    dev = Q.device
    if Q.ndim != 2 or Q.shape[0] == 0 or sel.ndim != 1:
        raise ValueError(f"Q must be [M, 3] with M >= 1 and sel [B]; got "
                         f"{tuple(Q.shape)} and {tuple(sel.shape)}")
    M, B = Q.shape[0], sel.shape[0]
    check(Q, "Q", torch.int32, (M, 3), dev)
    check(sel, "sel", torch.int32, (B,), dev)
    check(sel_cls, "sel_cls", torch.int32, (B,), dev)
    check(valid, "valid", torch.bool, (B,), dev)
    check_inv_rates(inv_rates, M, dev)
    Q_new = torch.empty((M, 3), dtype=torch.int32, device=dev)
    W = torch.empty(M, dtype=torch.float32, device=dev)
    launch(Q, sel, sel_cls, valid, inv_rates, Q_new, W)
    return Q_new, W


def launch(Q, sel, sel_cls, valid, inv_rates, Q_new, W) -> None:
    """Launch the kernel on the current stream into preallocated ``Q_new``
    and ``W``, with no checks: ``queue_update`` validates and allocates,
    and timing harnesses call this directly."""
    err = _fn()(Q.data_ptr(), sel.data_ptr(), sel_cls.data_ptr(),
                valid.data_ptr(), inv_rates.data_ptr(),
                0 if inv_rates.ndim == 1 else 3, Q.shape[0], sel.shape[0],
                Q_new.data_ptr(), W.data_ptr(),
                _P(torch.cuda.current_stream(Q.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"queue_update launch failed: CUDA error {err}")
    LAUNCHES["queue_update"] += 1
