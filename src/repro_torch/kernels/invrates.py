"""What the port's scheduler kernels share: the inverse-rate operand, the
CPU/CUDA dispatch rule, the launch counters and the wrappers' input checks.

Mirror of ``repro.kernels.invrates``.  Callers pass per-(server, class)
reciprocal service rates either as the homogeneous ``[3]`` vector or as a
per-server ``[M, 3]`` matrix; a zero-rate (drained / failed) entry carries
``+inf``.  ``encode`` splits that operand into lanes a kernel can multiply
safely:

  cols 0..2   finite reciprocal rates  (non-finite entries -> 0.0)
  col  3      zero padding
  cols 4..6   dead flags (1.0 where the reciprocal rate was non-finite)
  col  7      zero padding

Workloads multiply cols 0..2 (never ``0 * inf = NaN``), and any (server,
class) whose dead flag is set scores ``+inf`` after the multiply.  The
plain versions (ref.py) use this encoding; the CUDA kernel applies the
same rule element by element to the raw ``[3]`` / ``[M, 3]`` operand, so
a launch needs no encoding pass.

Dispatch rule (``use_kernel``): a tensor on the CPU goes to the plain
PyTorch version, a tensor on a CUDA device goes to the hand-written CUDA
kernel.  There is no fallback from one to the other.  ``LAUNCHES`` counts
each kernel's launches (one key per kernel), ``MATRIX_LAUNCHES`` those of
``route_commit`` at the ``[M, 3]`` operand; the CPU path and the plain
versions never touch them.
"""
from __future__ import annotations

import torch

CLASSES = 3
WIDTH = 8          # padded lane width: [rates 0..2 | 0 | flags 4..6 | 0]
FLAG_BASE = 4


LAUNCHES = {"route_commit_full": 0, "route_commit_pod": 0,
            "weighted_argmin": 0, "pod_route": 0, "queue_update": 0}
# of route_commit's launches, those at the per-server [M, 3] operand
MATRIX_LAUNCHES = {"route_commit_full": 0, "route_commit_pod": 0}


def reset_launch_counts() -> None:
    """Zero every launch counter."""
    for counts in (LAUNCHES, MATRIX_LAUNCHES):
        for k in counts:
            counts[k] = 0


def use_kernel(t: torch.Tensor, kernel: str) -> bool:
    """True for a CUDA tensor (launch ``kernel``), False for a CPU tensor
    (run its plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{kernel} runs on a CUDA or a CPU tensor, "
                     f"not on {t.device}")


def check(t: torch.Tensor, name: str, dtype, shape, device) -> None:
    """Raise unless ``t`` has this device, dtype (one dtype or a tuple of
    them) and shape and is contiguous: what a kernel's pointers assume."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype not in (dtype if isinstance(dtype, tuple) else (dtype,)):
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def check_inv_rates(inv_rates: torch.Tensor, M: int, device,
                    cells: int | None = None) -> None:
    """Check the ``[3]`` / ``[M, 3]`` float32 operand a kernel reads raw;
    with a count of ``cells``, also one ``[cells, M, 3]`` row a cell."""
    shapes = ((CLASSES,), (M, CLASSES)) + (
        () if cells is None else ((cells, M, CLASSES),))
    if tuple(inv_rates.shape) not in shapes:
        raise ValueError(f"inv_rates has shape {tuple(inv_rates.shape)}, "
                         f"expected one of {shapes}")
    check(inv_rates, "inv_rates", torch.float32, tuple(inv_rates.shape), device)


def as_matrix(inv_rates: torch.Tensor, M: int) -> torch.Tensor:
    """Broadcast a ``[3]`` homogeneous vector to ``[M, 3]``; pass ``[M, 3]``
    through.  Always float32."""
    inv = inv_rates.to(torch.float32)
    if inv.ndim == 1:
        inv = inv[None, :].expand(M, CLASSES)
    return inv


def encode(inv_rates: torch.Tensor, M: int, flags: bool = True) -> torch.Tensor:
    """Finite [M, 8] encoding of a [3] or [M, 3] inverse-rate operand.

    flags=False leaves cols 4..6 zero (consumers that only need the finite
    rates and treat dead entries as contributing no workload)."""
    inv = as_matrix(inv_rates, M)
    finite = torch.isfinite(inv)
    enc = torch.zeros((M, WIDTH), dtype=torch.float32, device=inv.device)
    enc[:, :CLASSES] = torch.where(finite, inv, 0.0)
    if flags:
        enc[:, FLAG_BASE:FLAG_BASE + CLASSES] = (~finite).to(torch.float32)
    return enc
