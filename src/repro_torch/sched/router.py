"""PodRouter — the paper's Balanced-Pandas-Pod as a request router over
model replicas, on the card.

PyTorch mirror of ``repro.sched.router``.  The router keeps the paper's
per-replica 3-sub-queue bookkeeping (``Q[m, c]``, requests queued at
replica m in locality class c) and its workload ``W_m = Q^l/alpha +
Q^k/beta + Q^r/gamma``, and routes each request batch with ONE
``kernels.route_commit`` launch: score, route and queue-commit with
sequential conflict resolution, so request b+1 scores against workloads
that already include request b's commit.

  policy="pod"  -> the pod variant over ``[B, 3 + d]`` candidates (the
                   request's locals, d_rack rack-local and d_remote remote
                   samples: O(d) probes a request, paper §IV-C)
  policy="full" -> the full variant over the ``[B, M]`` class matrix with a
                   random tie permutation (O(M) Balanced-Pandas)

Heterogeneous fleets pass ``rate_matrix`` ([M, 3] per-replica per-class
service rates); the kernel then takes the ``[M, 3]`` inverse-rate operand,
``+inf`` for a zero rate (a drained replica is never chosen while a live
candidate exists).

The class matrix and the candidates are built on the device for the whole
batch (no per-request Python loop), with the reference's semantics: every
replica in a local's pod is RACK, the locals themselves LOCAL, the rest
REMOTE; rack and remote candidates are drawn uniformly with replacement
from the replicas of that class, and a row whose pool is empty gets
invalid slots (index 0, class 0, ``valid`` False).

Random numbers come through one seam, a ``RouterDraws``: the default
``TorchRouterDraws`` draws from a ``torch.Generator`` on the router's
device; a test passes the reference's own draws instead (its candidates
come from numpy's generator and its tie permutation from a JAX key, which
torch cannot reproduce).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Protocol

import numpy as np
import torch

from ..core.cluster import LOCAL, RACK, REMOTE, Rates, uniform_int
from ..core.policies import PodSpec, pod_candidate_classes
from ..core.simulator import resolve_device
from ..kernels import route_commit
from ..kernels.ref import workload
from .locality import FleetTopology


@dataclasses.dataclass
class RouterStats:
    decisions: int = 0
    probes: int = 0
    routed_by_class: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.routed_by_class is None:
            self.routed_by_class = np.zeros(3, np.int64)


class RouterDraws(Protocol):
    """Every random number a ``PodRouter`` consumes, on its device."""

    def candidates(self, cls: torch.Tensor, locals_: torch.Tensor):
        """cls [B, M] int32, locals_ [B, r] int64 -> (idx [B, C] int32,
        ccls [B, C] int32, valid [B, C] bool): the pod variant's
        candidates, C = r + d."""

    def prio(self, M: int) -> torch.Tensor:
        """[M] int32 random permutation: the full variant's tie priority."""


def sample_candidates(gen: torch.Generator, cls: torch.Tensor,
                      locals_: torch.Tensor, pod: PodSpec):
    """The pod variant's candidates for a whole batch, on ``cls``'s device:
    the r locals (class LOCAL), then ``pod.d_rack`` uniform draws with
    replacement from each row's RACK replicas and ``pod.d_remote`` from its
    REMOTE ones.  The k-th replica of a class in a row is found by a
    search in the row's running count of that class.  Slots of a class a
    row lacks are invalid (index 0, class 0)."""
    B, r = locals_.shape
    dev = cls.device
    cand_cls = pod_candidate_classes(r, pod, dev)                # [C]
    want = cand_cls[r:]                                           # [d]
    pools = torch.arange(RACK, REMOTE + 1, dtype=torch.int32, device=dev)
    counts = (cls[None] == pools[:, None, None]).cumsum(-1, dtype=torch.int32)
    n_rack, n_remote = counts[0, :, -1:], counts[1, :, -1:]       # [B, 1]
    n_slot = torch.where(want == REMOTE, n_remote, n_rack)        # [B, d]
    k = uniform_int(gen, n_slot.shape, n_slot.to(torch.float32), dev)
    k_rack, k_remote = (t.contiguous() for t in k.split([pod.d_rack, pod.d_remote], 1))
    # the first replica whose running count passes k: the (k+1)-th of its class
    idx = torch.cat([torch.searchsorted(counts[0], k_rack, right=True),
                     torch.searchsorted(counts[1], k_remote, right=True)], dim=1)
    ok = n_slot > 0
    idx = torch.cat([locals_.to(torch.int32), torch.where(ok, idx, 0).to(torch.int32)], 1)
    valid = torch.cat([ok.new_ones((B, r)), ok], dim=1)
    return idx, torch.where(valid, cand_cls, 0), valid


class TorchRouterDraws:
    """Default draws from a ``torch.Generator`` seeded with ``seed`` on
    ``device``: ``sample_candidates`` for the pod variant, ``randperm`` for
    the full variant's tie permutation."""

    def __init__(self, seed: int, device, pod: PodSpec = PodSpec(2, 6)):
        self.pod = pod
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(int(seed))

    def candidates(self, cls: torch.Tensor, locals_: torch.Tensor):
        return sample_candidates(self.gen, cls, locals_, self.pod)

    def prio(self, M: int) -> torch.Tensor:
        return torch.randperm(M, generator=self.gen, device=self.gen.device
                              ).to(torch.int32)


class SharedDraws:
    """A ``RouterDraws`` that keeps what ``inner`` last drew, so that a
    second router can be handed the same draws through ``echo(device)``:
    the way a CPU router checks the card's batch for batch (the second
    router routes each batch right after the first)."""

    def __init__(self, inner: RouterDraws):
        self.inner, self.last = inner, None

    def candidates(self, cls: torch.Tensor, locals_: torch.Tensor):
        self.last = self.inner.candidates(cls, locals_)
        return self.last

    def prio(self, M: int) -> torch.Tensor:
        self.last = self.inner.prio(M)
        return self.last

    def echo(self, device) -> RouterDraws:
        """The second router's seam: the last draws, moved to ``device``."""
        shared, dev = self, torch.device(device)

        class Echo:
            def candidates(self, cls, locals_):
                return tuple(t.to(dev) for t in shared.last)

            def prio(self, M):
                return shared.last.to(dev)
        return Echo()


class PodRouter:
    def __init__(self, fleet: FleetTopology, rates: Rates,
                 policy: str = "pod", pod: PodSpec = PodSpec(2, 6),
                 seed: int = 0,
                 rate_matrix: Optional[np.ndarray] = None, *,
                 device=None, draws: Optional[RouterDraws] = None):
        if policy not in ("pod", "full"):
            raise ValueError(f"policy must be 'pod' or 'full', not {policy!r}")
        self.device = resolve_device(device)
        self.fleet = fleet
        self.rates = rates
        self.policy = policy
        self.pod = pod
        self.M = fleet.n_replicas
        dev = self.device
        self.Q = torch.zeros((self.M, 3), dtype=torch.int32, device=dev)
        self.W = torch.zeros((self.M,), dtype=torch.float32, device=dev)
        # inverse rates in float32 on the host, as the reference computes them
        inv = 1.0 / np.array([rates.alpha, rates.beta, rates.gamma], np.float32)
        self.inv_rates = torch.from_numpy(inv).to(dev)
        self.inv_rate_m = None
        if rate_matrix is not None:
            rm = np.asarray(rate_matrix, np.float32)
            if rm.shape != (self.M, 3):
                raise ValueError(f"rate_matrix has shape {rm.shape}, expected ({self.M}, 3)")
            # zero-rate (drained) replicas -> +inf inverse rate, never chosen
            with np.errstate(divide="ignore"):
                inv_m = np.where(rm > 0, 1.0 / rm, np.float32(np.inf)).astype(np.float32)
            self.inv_rate_m = torch.from_numpy(inv_m).to(dev)
        inv_all = self._inv
        # workloads count a dead (non-finite) rate as 0, as queue_update does
        self._finite = torch.where(torch.isfinite(inv_all), inv_all, 0.0)
        self.draws = draws if draws is not None else TorchRouterDraws(seed, dev, pod)
        self.stats = RouterStats()
        R = self.M // fleet.n_pods
        self._pod_of = torch.arange(self.M, device=dev) // R
        self._n_pods = (self.M - 1) // R + 1
        self.last_classes: Optional[np.ndarray] = None

    @property
    def heterogeneous(self) -> bool:
        return self.inv_rate_m is not None

    @property
    def _inv(self) -> torch.Tensor:
        """The kernel's inverse-rate operand: [M, 3] when heterogeneous,
        the homogeneous [3] vector otherwise."""
        return self.inv_rate_m if self.heterogeneous else self.inv_rates

    # -- locality classes for a request batch ------------------------------

    def _classes(self, locals_: torch.Tensor) -> torch.Tensor:
        """locals_: [B, r] int64 replica ids holding each request's prefix,
        on the device.  Returns the [B, M] int32 class matrix."""
        B = locals_.shape[0]
        hit = torch.zeros((B, self._n_pods), dtype=torch.bool, device=self.device)
        hit.scatter_(1, self._pod_of[locals_], True)
        cls = torch.where(hit[:, self._pod_of], RACK, REMOTE).to(torch.int32)
        return cls.scatter_(1, locals_, LOCAL)

    # -- the routing call ----------------------------------------------------

    def route(self, locals_: np.ndarray) -> np.ndarray:
        """Route a batch of requests; locals_: [B, r] replica ids holding
        each request's prefix.  Returns the chosen replica ids [B] (int32)
        and keeps the class each was routed at in ``last_classes``.

        One route_commit launch a batch: request b+1 scores against
        workloads including request b's commit, and Q / W come back
        updated from the same kernel."""
        loc = torch.as_tensor(np.asarray(locals_), dtype=torch.int64).to(self.device)
        B = loc.shape[0]
        cls = self._classes(loc)
        valid_b = torch.ones((B,), dtype=torch.bool, device=self.device)
        if self.policy == "full":
            # random tie priority per batch: W is lattice-valued, exact
            # ties are routine, and index-order ties hotspot low replicas
            self.Q, self.W, sel, sel_cls, _ = route_commit(
                self.Q, valid_b, self._inv, cls=cls, prio=self.draws.prio(self.M))
            self.stats.probes += B * self.M
        else:
            idx, ccls, valid = self.draws.candidates(cls, loc)
            self.Q, self.W, sel, sel_cls, _ = route_commit(
                self.Q, valid_b, self._inv, cand_idx=idx, cand_cls=ccls,
                cand_valid=valid)
            self.stats.probes += B * idx.shape[1]
        self.stats.decisions += B
        sel, self.last_classes = torch.stack([sel, sel_cls]).cpu().numpy()
        np.add.at(self.stats.routed_by_class, self.last_classes, 1)
        return sel

    def complete(self, replica_ids: np.ndarray, classes: np.ndarray):
        """Mark requests finished (dequeue bookkeeping)."""
        ids = torch.as_tensor(np.asarray(replica_ids), dtype=torch.int64)
        cl = torch.as_tensor(np.asarray(classes), dtype=torch.int64)
        dec = torch.zeros((self.M, 3), dtype=torch.int32, device=self.device)
        dec.index_put_((ids.to(self.device), cl.to(self.device)),
                       torch.ones((), dtype=torch.int32, device=self.device),
                       accumulate=True)
        self.Q = torch.clamp(self.Q - dec, min=0)
        # the reference's three-term row sum, (q0*i0 + q1*i1) + q2*i2 on
        # XLA's CPU backend, written out so the card adds in that order
        self.W = workload(self.Q, self._finite)
