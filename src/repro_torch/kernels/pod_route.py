"""Snapshot O(d) Balanced-Pandas-Pod routing over candidate lists.

Port of ``repro.kernels.pod_route`` (the Pallas TPU kernel ``_kernel``).
On a CUDA tensor the wrapper launches the hand-written kernel in
``csrc/snapshot_route.cu`` (sm_90a, built with nvcc and bound with ctypes
by ``build.py``); on a CPU tensor it runs the plain version
``ref.pod_route_ref``.  The two compute the same function, bit for bit.
Where the TPU kernel gathered ``W[cand]`` and the rates with a one-hot
matmul, the CUDA kernel loads them by index, as the plain version does;
it is a programmatic dependent launch (see the kernel source).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import build
from .invrates import LAUNCHES, check, check_inv_rates, use_kernel
from .ref import pod_route_ref
from .weighted_argmin import W_DTYPES

THREADS = 128           # four warps; 8 lanes a task (kPodLanes), 16 tasks a block

_P = ctypes.c_void_p
_I = ctypes.c_int


@functools.cache
def _fn():
    """The kernel's C entry point with its signature declared."""
    fn = build.load("snapshot_route").pod_route
    fn.argtypes = [_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _I, _P]
    fn.restype = _I
    return fn


def pod_route(W: torch.Tensor, cand_idx: torch.Tensor, cand_cls: torch.Tensor,
              valid: torch.Tensor, inv_rates: torch.Tensor):
    """Per task b, ``cand_idx[b, c*]`` for the lowest slot c* minimising
    ``W[cand] * inv[cand, cls]`` over its valid candidates.

    W: [M] float32 or bfloat16; cand_idx/cand_cls: [B, C] int32 (class 3
    scores +inf); valid: [B, C] bool; inv_rates: [3] or [M, 3] float32.
    Returns (sel [B] int32, val [B] float32), as ``ref.pod_route_ref``.
    """
    if not use_kernel(W, "pod_route"):
        return pod_route_ref(W, cand_idx, cand_cls, valid, inv_rates)
    dev = W.device
    if cand_idx.ndim != 2 or 0 in cand_idx.shape or W.ndim != 1 or W.numel() == 0:
        raise ValueError(f"cand_idx must be [B, C] and W [M], all >= 1; got "
                         f"{tuple(cand_idx.shape)} and {tuple(W.shape)}")
    B, C = cand_idx.shape
    M = W.shape[0]
    check(W, "W", W_DTYPES, (M,), dev)
    check(cand_idx, "cand_idx", torch.int32, (B, C), dev)
    check(cand_cls, "cand_cls", torch.int32, (B, C), dev)
    check(valid, "valid", torch.bool, (B, C), dev)
    check_inv_rates(inv_rates, M, dev)
    sel = torch.empty(B, dtype=torch.int32, device=dev)
    val = torch.empty(B, dtype=torch.float32, device=dev)
    launch(W, cand_idx, cand_cls, valid, inv_rates, sel, val)
    return sel, val


def launch(W, cand_idx, cand_cls, valid, inv_rates, sel, val) -> None:
    """Launch the kernel on the current stream into preallocated ``sel``
    and ``val``, with no checks: ``pod_route`` validates and allocates,
    and timing harnesses call this directly."""
    B, C = cand_idx.shape
    err = _fn()(W.data_ptr(), int(W.dtype == torch.bfloat16),
                cand_idx.data_ptr(), cand_cls.data_ptr(), valid.data_ptr(),
                inv_rates.data_ptr(), 0 if inv_rates.ndim == 1 else 3,
                W.shape[0], B, C, sel.data_ptr(), val.data_ptr(), THREADS,
                _P(torch.cuda.current_stream(cand_idx.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"pod_route launch failed: CUDA error {err}")
    LAUNCHES["pod_route"] += 1
