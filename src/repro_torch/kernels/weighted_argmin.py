"""Snapshot O(M) Balanced-Pandas routing of an arrival batch.

Port of ``repro.kernels.weighted_argmin`` (the Pallas TPU kernel
``_kernel``).  On a CUDA tensor the wrapper launches the hand-written
kernel in ``csrc/snapshot_route.cu`` (sm_90a, built with nvcc and bound
with ctypes by ``build.py``); on a CPU tensor it runs the plain version
``ref.weighted_argmin_ref``.  The two compute the same function, bit for
bit: see the kernel source for the rules and the order of work.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .invrates import LAUNCHES, check, check_inv_rates, use_kernel
from .ref import weighted_argmin_ref

THREADS = 256           # a block a task row (the kernel takes at most 256)
W_DTYPES = (torch.float32, torch.bfloat16)

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _fn():
    """The kernel's C entry point with its signature declared."""
    fn = build.load("snapshot_route").weighted_argmin
    fn.argtypes = [_P, _I, _P, _P, _I, _I, _I, _P, _P, _I, _P]
    fn.restype = _I
    return fn


def weighted_argmin(W: torch.Tensor, cls: torch.Tensor,
                    inv_rates: torch.Tensor):
    """Per task b, the lowest server m minimising ``W[m] * inv[m, cls[b, m]]``.

    W: [M] float32 or bfloat16; cls: [B, M] int32 (class 3 scores +inf);
    inv_rates: [3] or [M, 3] float32 (+inf = dead, scores +inf).
    Returns (sel [B] int32, val [B] float32), as ``ref.weighted_argmin_ref``.
    """
    if not use_kernel(W, "weighted_argmin"):
        return weighted_argmin_ref(W, cls, inv_rates)
    dev = W.device
    if cls.ndim != 2 or 0 in cls.shape:
        raise ValueError(f"cls must be [B, M] with B, M >= 1, got {tuple(cls.shape)}")
    B, M = cls.shape
    check(cls, "cls", torch.int32, (B, M), dev)
    check(W, "W", W_DTYPES, (M,), dev)
    check_inv_rates(inv_rates, M, dev)
    sel = torch.empty(B, dtype=torch.int32, device=dev)
    val = torch.empty(B, dtype=torch.float32, device=dev)
    launch(W, cls, inv_rates, sel, val)
    return sel, val


def launch(W, cls, inv_rates, sel, val) -> None:
    """Launch the kernel on the current stream into preallocated ``sel``
    and ``val``, with no checks: ``weighted_argmin`` validates and
    allocates, and timing harnesses call this directly."""
    B, M = cls.shape
    err = _fn()(W.data_ptr(), int(W.dtype == torch.bfloat16), cls.data_ptr(),
                inv_rates.data_ptr(), 0 if inv_rates.ndim == 1 else 3, M, B,
                sel.data_ptr(), val.data_ptr(), THREADS,
                _P(torch.cuda.current_stream(cls.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"weighted_argmin launch failed: CUDA error {err}")
    LAUNCHES["weighted_argmin"] += 1
