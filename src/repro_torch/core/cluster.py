"""Cluster topology: M servers in K equal racks, 3-level data locality.

PyTorch mirror of ``repro.core.cluster`` (paper §III).  A task's data chunk
lives on ``n_replicas`` "local" servers; servers sharing a rack with one of
them are "rack-local"; everything else is "remote".  Service durations are
geometric (the paper's discrete-time model) or discretized log-normal (its
heavy-tail simulations), with per-slot rates alpha > beta > gamma.

Random numbers come from an explicit ``torch.Generator``; they cannot
reproduce JAX's threefry stream, so tests compare these samplers with the
JAX ones by distribution.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

LOCAL, RACK, REMOTE = 0, 1, 2


class Rates(NamedTuple):
    """Per-slot service completion probabilities (local, rack-local, remote)."""

    alpha: float = 0.04
    beta: float = 0.02
    gamma: float = 0.008

    def as_array(self, device="cpu") -> torch.Tensor:
        """[3] float32 (alpha, beta, gamma)."""
        return torch.tensor([self.alpha, self.beta, self.gamma],
                            dtype=torch.float32, device=device)

    def mean_slots(self, device="cpu") -> torch.Tensor:
        """[3] float32 mean service slots per locality class (1 / rate)."""
        return 1.0 / self.as_array(device)


@dataclasses.dataclass(frozen=True)
class Cluster:
    """Static cluster topology (hashable: plain ints)."""

    M: int  # number of servers
    K: int  # number of racks (M % K == 0)
    n_replicas: int = 3  # local servers per task (Hadoop default)

    def __post_init__(self):
        if self.M % self.K != 0:
            raise ValueError(f"M={self.M} must be divisible by K={self.K}")
        if self.n_replicas >= self.M:
            raise ValueError("need n_replicas < M")

    @property
    def rack_size(self) -> int:
        """Servers per rack (M / K; checked divisible)."""
        return self.M // self.K

    @property
    def rack_of(self) -> torch.Tensor:
        """[M] int32 rack index of each server, on the CPU (servers are
        contiguous by rack)."""
        return torch.arange(self.M, dtype=torch.int32) // self.rack_size

    @property
    def same_rack(self) -> torch.Tensor:
        """[M, M] bool same-rack incidence, on ``rack_of``'s device."""
        r = self.rack_of
        return r[:, None] == r[None, :]


def _uniform(gen: torch.Generator, shape, device) -> torch.Tensor:
    return torch.rand(shape, generator=gen, device=device, dtype=torch.float32)


def uniform_open(gen: torch.Generator, shape, device) -> torch.Tensor:
    """Uniform float32 on [1e-7, 1 - 1e-7] (the geometric sampler's range:
    log1p(-u) stays finite)."""
    return _uniform(gen, shape, device) * (1.0 - 2e-7) + 1e-7


def uniform_int(gen: torch.Generator, shape, high, device) -> torch.Tensor:
    """int32 uniform on [0, high) by scaling a uniform: ``high`` is an int
    or a tensor broadcast against ``shape`` (per-column bounds), each below
    2**24.  torch.rand is a multiple of 2**-24 below 1, so u * high
    truncates below high."""
    return (_uniform(gen, shape, device) * high).to(torch.int32)


def sample_locals(gen: torch.Generator, cluster: Cluster, batch: int,
                  device="cpu") -> torch.Tensor:
    """``batch`` tasks' local-server triples, distinct within a task.

    Returns int32 [batch, n_replicas].  Sequential-skip sampling, as in the
    JAX reference: the i-th replica is drawn uniformly from the M-i servers
    not yet chosen and mapped back by skipping the earlier picks in
    ascending order."""
    n = cluster.n_replicas
    high = torch.arange(cluster.M, cluster.M - n, -1, dtype=torch.float32,
                        device=device)
    draws = uniform_int(gen, (batch, n), high, device)
    picks = [draws[:, 0]]
    for i in range(1, n):
        d = draws[:, i]
        prev = torch.stack(picks, dim=1).sort(dim=1).values if i > 1 else picks[0][:, None]
        for j in range(i):
            d = d + (d >= prev[:, j])
        picks.append(d)
    return torch.stack(picks, dim=1)


def locality_class(cluster: Cluster, locals_: torch.Tensor) -> torch.Tensor:
    """Per-server locality class for a batch of tasks.

    locals_: int32 [..., n_replicas].  Returns int32 [..., M] with values
    LOCAL / RACK / REMOTE."""
    m = torch.arange(cluster.M, dtype=torch.int32, device=locals_.device)
    R = cluster.rack_size
    is_local = (locals_[..., None] == m).any(dim=-2)             # [..., M]
    in_local_rack = ((locals_ // R)[..., None] == (m // R)).any(dim=-2)
    cls = torch.where(is_local, LOCAL, torch.where(in_local_rack, RACK, REMOTE))
    return cls.to(torch.int32)


def capacity_arrival_rate(cluster: Cluster, rates: Rates, load: float) -> float:
    """Arrival rate (tasks/slot) at ``load`` fraction of the capacity edge
    ``M * alpha`` (symmetric random locality: every task can be served
    locally at the boundary)."""
    return float(load) * cluster.M * rates.alpha


def rate_matrix(rates: Rates, speed: torch.Tensor) -> torch.Tensor:
    """[M, 3] per-server per-class service rates.

    speed: [M] whole-server multipliers, or [M, 3] per-class multipliers."""
    if speed.ndim == 1:
        speed = speed[:, None]
    return speed * rates.as_array(speed.device)[None, :]


def safe_inv_rates(rate_m: torch.Tensor) -> torch.Tensor:
    """Reciprocal of a rate array in float32; zero-rate (drained / failed)
    entries carry ``+inf`` — the kernels' contract (kernels/invrates.py)."""
    rate_m = rate_m.to(torch.float32)
    return torch.where(rate_m > 0, 1.0 / torch.clamp_min(rate_m, 1e-12),
                       float("inf"))


def inv_rate_matrix(rates: Rates, speed: torch.Tensor) -> torch.Tensor:
    """[M, 3] reciprocal rates (mean service slots), +inf at speed 0."""
    return safe_inv_rates(rate_matrix(rates, speed))


GEOMETRIC = "geometric"
LOGNORMAL = "lognormal"

_MAX_DURATION = 1_000_000  # safety clip, >> any mean we use


def durations_from_uniform(u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Geometric durations ceil(log1p(-u) / log1p(-p)), clipped to
    [1, 1e6], int32; u in (0, 1)."""
    d = torch.ceil(torch.log1p(-u) / torch.log1p(-p))
    return torch.clamp(d, 1, _MAX_DURATION).to(torch.int32)


def durations_from_normal(z: torch.Tensor, p: torch.Tensor,
                          sigma: float) -> torch.Tensor:
    """Log-normal durations ceil(exp(mu + sigma z)), mu = -log p - sigma^2/2
    (continuous mean 1/p), clipped to [1, 1e6], int32."""
    mu = -torch.log(p) - 0.5 * sigma * sigma
    d = torch.ceil(torch.exp(mu + sigma * z))
    return torch.clamp(d, 1, _MAX_DURATION).to(torch.int32)


def sample_durations(gen: torch.Generator, cls: torch.Tensor, rates: Rates,
                     dist: str = GEOMETRIC, sigma: float = 1.0) -> torch.Tensor:
    """Integer service durations (slots, >= 1) for tasks of class ``cls``
    (int32 [...], values in {LOCAL, RACK, REMOTE}).

    geometric:  P(D = k) = p (1-p)^{k-1},  mean 1/p,  p = rates[cls].
    lognormal:  ceil(LogNormal(mu_c, sigma)), continuous mean 1/p."""
    p = rates.as_array(cls.device)[cls.to(torch.int64)]
    if dist == GEOMETRIC:
        return durations_from_uniform(uniform_open(gen, cls.shape, cls.device), p)
    if dist == LOGNORMAL:
        z = torch.randn(cls.shape, generator=gen, device=cls.device)
        return durations_from_normal(z, p, sigma)
    raise ValueError(f"unknown service distribution {dist!r}")
