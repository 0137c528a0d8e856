"""Fused score -> route -> queue-commit of one arrival batch.

Port of ``repro.kernels.route_commit`` (the Pallas TPU kernels
``_kernel_full`` and ``_kernel_pod``).  On a CUDA tensor the wrapper
launches the hand-written kernel in ``csrc/route_commit.cu`` (sm_90a, built
with nvcc and bound with ctypes by ``build.py``); on a CPU tensor it runs
the plain version ``ref.route_commit_ref``.  The two compute the same
function: see the kernel source for the order of work and the parity rules.

Two variants share the wrapper:

  full  (``cls``: [B, M], optional ``prio``: [M]) — Balanced-Pandas argmin
        over every server;
  pod   (``cand_idx``/``cand_cls``/``cand_valid``: [B, C]) — power-of-d
        argmin over an explicit candidate list.

``invrates.LAUNCHES`` counts kernel launches per variant (and
``MATRIX_LAUNCHES`` those at the [M, 3] operand); the CPU path and the
plain version never touch them.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from . import build
from .invrates import (LAUNCHES, MATRIX_LAUNCHES, check, check_inv_rates,
                       use_kernel)
from .ref import route_commit_ref

THREADS_FULL = 1024     # full: at most this many, one owner thread a server
THREADS_POD = 512       # pod: warp 0 walks the chain, the rest cover all M
_MAX_M = 32767          # (cls*M + prio)*M + m must fit in a uint32 rank lane
_SMEM_LIMIT = 232_448   # bytes of shared memory one H100 block may use

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("route_commit")
    lib.route_commit_full.argtypes = [_P, _P, _P, _I, _P, _P, _I, _I,
                                      _P, _P, _P, _P, _P, _I, _P]
    lib.route_commit_full.restype = _I
    lib.route_commit_pod.argtypes = [_P, _P, _P, _I, _P, _P, _P, _I, _I,
                                     _I, _P, _P, _P, _P, _P, _I, _P]
    lib.route_commit_pod.restype = _I
    return lib


def route_commit(Q: torch.Tensor, valid: torch.Tensor,
                 inv_rates: torch.Tensor, *,
                 cls: Optional[torch.Tensor] = None,
                 prio: Optional[torch.Tensor] = None,
                 cand_idx: Optional[torch.Tensor] = None,
                 cand_cls: Optional[torch.Tensor] = None,
                 cand_valid: Optional[torch.Tensor] = None):
    """Sequential-commit routing of one arrival batch.

    Q: [M, 3] int32; valid: [B] bool; inv_rates: [3] or [M, 3] float32
    (+inf = dead).  Exactly one of ``cls`` [B, M] int32 (+ optional
    ``prio`` [M] int32, a permutation of 0..M-1) or
    ``cand_idx``/``cand_cls`` [B, C] int32 with ``cand_valid`` [B, C] bool.

    Returns (Q_new [M, 3] int32, W_new [M] f32, sel [B] int32,
    sel_cls [B] int32, val [B] f32), as ``ref.route_commit_ref``.
    """
    if (cls is None) == (cand_idx is None):
        raise ValueError("pass cls OR cand_idx/cand_cls/cand_valid")
    if cand_idx is not None and (prio is not None or cand_cls is None
                                 or cand_valid is None):
        raise ValueError("the pod variant takes cand_idx, cand_cls and "
                         "cand_valid, and no prio")
    if not use_kernel(Q, "route_commit"):
        return route_commit_ref(Q, valid, inv_rates, cls=cls, prio=prio,
                                cand_idx=cand_idx, cand_cls=cand_cls,
                                cand_valid=cand_valid)

    dev = Q.device
    M = Q.shape[0]
    B = valid.shape[0]
    if not 0 < M <= _MAX_M or 8 * M > _SMEM_LIMIT:
        raise ValueError(f"route_commit kernel supports 0 < M <= {_MAX_M}")
    check(Q, "Q", torch.int32, (M, 3), dev)
    check(valid, "valid", torch.bool, (B,), dev)
    check_inv_rates(inv_rates, M, dev)

    if cls is not None:
        check(cls, "cls", torch.int32, (B, M), dev)
        if prio is not None:
            check(prio, "prio", torch.int32, (M,), dev)
    else:
        C = cand_idx.shape[1] if cand_idx.ndim == 2 else -1
        check(cand_idx, "cand_idx", torch.int32, (B, C), dev)
        check(cand_cls, "cand_cls", torch.int32, (B, C), dev)
        check(cand_valid, "cand_valid", torch.bool, (B, C), dev)
    outs = (torch.empty((M, 3), dtype=torch.int32, device=dev),
            torch.empty(M, dtype=torch.float32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.float32, device=dev))
    launch(Q, valid, inv_rates, outs, cls=cls, prio=prio, cand_idx=cand_idx,
           cand_cls=cand_cls, cand_valid=cand_valid)
    return outs


def launch(Q, valid, inv_rates, outs, *, cls=None, prio=None,
           cand_idx=None, cand_cls=None, cand_valid=None) -> None:
    """Launch the kernel on the current stream into preallocated ``outs``
    (Q_new, W_new, sel, sel_cls, val), with no checks: ``route_commit``
    validates and allocates, and timing harnesses call this directly."""
    M, B = Q.shape[0], valid.shape[0]
    stride = 0 if inv_rates.ndim == 1 else 3
    stream = _P(torch.cuda.current_stream(Q.device).cuda_stream)
    ptrs = [t.data_ptr() for t in outs]
    if cls is not None:
        err = _lib().route_commit_full(
            Q.data_ptr(), valid.data_ptr(), inv_rates.data_ptr(), stride,
            cls.data_ptr(), None if prio is None else prio.data_ptr(), M, B,
            *ptrs, min(THREADS_FULL, -(-M // 32) * 32), stream)
        name = "route_commit_full"
    else:
        err = _lib().route_commit_pod(
            Q.data_ptr(), valid.data_ptr(), inv_rates.data_ptr(), stride,
            cand_idx.data_ptr(), cand_cls.data_ptr(), cand_valid.data_ptr(),
            M, B, cand_idx.shape[1], *ptrs, THREADS_POD, stream)
        name = "route_commit_pod"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    MATRIX_LAUNCHES[name] += stride == 3
