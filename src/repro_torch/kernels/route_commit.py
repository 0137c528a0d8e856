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

A leading cell axis routes N independent batches in one launch (one CTA a
cell): ``Q`` [N, M, 3] and ``valid`` [N, B], and every other operand either
per cell (with the leading N) or shared by all cells (without it, read at a
cell stride of 0), as the grid simulator shares the rates, BP-Pod's
candidate classes and batched JSQ's all-valid mask.

``invrates.LAUNCHES`` counts kernel launches per variant, one a call however
many cells it routes (and ``MATRIX_LAUNCHES`` those at an [M, 3] operand);
the CPU path and the plain version never touch them.  Under a recording
``torch.profiler`` the wrapper is the host span ``kernels.route_commit``
(``repro_torch.spans``), on either path.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from ..spans import span
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
_STRIDES = ctypes.c_longlong * 6


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared."""
    lib = build.load("route_commit")
    lib.route_commit_full.argtypes = [_P, _P, _P, _I, _P, _P, _I, _I,
                                      _P, _P, _P, _P, _P, _I, _I, _P, _P]
    lib.route_commit_full.restype = _I
    lib.route_commit_pod.argtypes = [_P, _P, _P, _I, _P, _P, _P, _I, _I,
                                     _I, _P, _P, _P, _P, _P, _I, _I, _P, _P]
    lib.route_commit_pod.restype = _I
    return lib


def route_commit(Q: torch.Tensor, valid: torch.Tensor,
                 inv_rates: torch.Tensor, *,
                 cls: Optional[torch.Tensor] = None,
                 prio: Optional[torch.Tensor] = None,
                 cand_idx: Optional[torch.Tensor] = None,
                 cand_cls: Optional[torch.Tensor] = None,
                 cand_valid: Optional[torch.Tensor] = None):
    """Sequential-commit routing of one arrival batch, or of one batch in
    each of N cells.

    Q: [M, 3] int32; valid: [B] bool; inv_rates: [3] or [M, 3] float32
    (+inf = dead).  Exactly one of ``cls`` [B, M] int32 (+ optional
    ``prio`` [M] int32, a permutation of 0..M-1) or
    ``cand_idx``/``cand_cls`` [B, C] int32 with ``cand_valid`` [B, C] bool.
    With a cell axis, Q is [N, M, 3] and valid [N, B]; inv_rates may also
    be [N, M, 3], and every other operand [N, ...] or shared.

    Returns (Q_new [M, 3] int32, W_new [M] f32, sel [B] int32,
    sel_cls [B] int32, val [B] f32), as ``ref.route_commit_ref``; with a
    cell axis each with a leading [N].
    """
    with span("kernels.route_commit"):
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
        lead = tuple(Q.shape[:1]) if Q.ndim == 3 else ()
        M = Q.shape[-2] if Q.ndim >= 2 else -1
        B = valid.shape[-1] if valid.ndim else -1
        if not 0 < M <= _MAX_M or 8 * M > _SMEM_LIMIT:
            raise ValueError(f"route_commit kernel supports 0 < M <= {_MAX_M}")
        if lead and lead[0] < 1:
            raise ValueError("route_commit needs at least one cell")
        check(Q, "Q", torch.int32, lead + (M, 3), dev)
        check(valid, "valid", torch.bool, lead + (B,), dev)
        check_inv_rates(inv_rates, M, dev, lead[0] if lead else None)

        if cls is not None:
            _check_operand(cls, "cls", torch.int32, (B, M), lead, dev)
            if prio is not None:
                _check_operand(prio, "prio", torch.int32, (M,), lead, dev)
        else:
            C = cand_idx.shape[-1] if cand_idx.ndim >= 2 else -1
            _check_operand(cand_idx, "cand_idx", torch.int32, (B, C), lead, dev)
            _check_operand(cand_cls, "cand_cls", torch.int32, (B, C), lead, dev)
            _check_operand(cand_valid, "cand_valid", torch.bool, (B, C), lead, dev)
        outs = (torch.empty(lead + (M, 3), dtype=torch.int32, device=dev),
                torch.empty(lead + (M,), dtype=torch.float32, device=dev),
                torch.empty(lead + (B,), dtype=torch.int32, device=dev),
                torch.empty(lead + (B,), dtype=torch.int32, device=dev),
                torch.empty(lead + (B,), dtype=torch.float32, device=dev))
        launch(Q, valid, inv_rates, outs, cls=cls, prio=prio, cand_idx=cand_idx,
               cand_cls=cand_cls, cand_valid=cand_valid)
        return outs


def _check_operand(t: torch.Tensor, name: str, dtype, shape, lead, device) -> None:
    """``check`` an operand that is per cell (``lead + shape``) or, with a
    cell axis, shared by every cell (``shape``)."""
    check(t, name, dtype, (lead if t.ndim > len(shape) else ()) + shape, device)


def _cell_stride(t: Optional[torch.Tensor], rank: int) -> int:
    """Elements between two cells' blocks of an operand of one-cell rank
    ``rank``: 0 when every cell shares it."""
    return t[0].numel() if t is not None and t.ndim > rank else 0


def launch(Q, valid, inv_rates, outs, *, cls=None, prio=None,
           cand_idx=None, cand_cls=None, cand_valid=None) -> None:
    """Launch the kernel on the current stream into preallocated ``outs``
    (Q_new, W_new, sel, sel_cls, val), with no checks: ``route_commit``
    validates and allocates, and timing harnesses call this directly.  A
    Q with a leading cell axis launches one CTA a cell."""
    cells = Q.shape[0] if Q.ndim == 3 else 1
    M, B = Q.shape[-2], valid.shape[-1]
    stride = 0 if inv_rates.ndim == 1 else 3
    strides = [_cell_stride(Q, 2), _cell_stride(valid, 1),
               _cell_stride(inv_rates, 2)]
    stream = _P(torch.cuda.current_stream(Q.device).cuda_stream)
    ptrs = [t.data_ptr() for t in outs]
    if cls is not None:
        strides += [_cell_stride(cls, 2), _cell_stride(prio, 1)]
        err = _lib().route_commit_full(
            Q.data_ptr(), valid.data_ptr(), inv_rates.data_ptr(), stride,
            cls.data_ptr(), None if prio is None else prio.data_ptr(), M, B,
            *ptrs, min(THREADS_FULL, -(-M // 32) * 32), cells,
            _STRIDES(*strides), stream)
        name = "route_commit_full"
    else:
        strides += [_cell_stride(t, 2) for t in (cand_idx, cand_cls, cand_valid)]
        err = _lib().route_commit_pod(
            Q.data_ptr(), valid.data_ptr(), inv_rates.data_ptr(), stride,
            cand_idx.data_ptr(), cand_cls.data_ptr(), cand_valid.data_ptr(),
            M, B, cand_idx.shape[-1], *ptrs, THREADS_POD, cells,
            _STRIDES(*strides), stream)
        name = "route_commit_pod"
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
    MATRIX_LAUNCHES[name] += stride == 3
