"""Discrete-time slotted simulator, Balanced-Pandas family (paper §III-IV).

PyTorch mirror of the BP family of ``repro.core.simulator``:

  balanced_pandas            routing: argmin weighted workload over all M
  balanced_pandas_pod        routing: argmin over the 3 locals + d samples
  balanced_pandas_randomtie  balanced_pandas with random (not class-first)
                             ties on the sequential path
  scheduling (all): an idle server serves its own local queue, then
  rack-local, then remote.

Within a slot the order is completions -> scheduling -> arrivals, and the
task count N is read at slot end, so Little's law gives the mean completion
time.  The slot loop is a Python loop over T slots; in the batched route
mode (the main path) nothing in it reads a device value on the host, so
the card runs ahead of the loop.

Routing modes:
  batched    — the slot's arrival batch routes through ONE launch of the
               ``route_commit`` kernel (kernels/route_commit.py): each
               arrival scores against the workloads left by the previous
               one's commit; exact ties break by locality class, then a
               per-slot random priority (full BP) or candidate slot (pod).
  sequential — plain per-arrival PyTorch routing with random tie-breaks,
               the paper's model, what the batched path is checked against.
               It reads each slot's arrival count on the host.

Random draws.  torch's generators cannot reproduce JAX's threefry stream,
so a slot takes all of its random numbers through one seam, ``SlotDraws``.
The default source (``TorchDraws``) fills it from a ``torch.Generator``;
a test fills it from the JAX key derivation instead and then holds the
port's slot step to the reference's, bit for bit.

Only the ``uniform`` scenario is ported (unit speeds, stationary traffic,
uniform placement: the reference's homogeneous fast path).  Telemetry, the
SQ and FCFS families and the grid entry points come with later slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..kernels.ref import workload
from ..kernels.route_commit import route_commit
from ..scenarios.build import realize
from .cluster import (GEOMETRIC, LOGNORMAL, Cluster, Rates,
                      durations_from_normal, durations_from_uniform,
                      locality_class, safe_inv_rates, sample_locals,
                      uniform_open)
from .policies import (PodSpec, bp_candidates_per_route, pod_candidate_classes,
                       pod_candidates, route_balanced_pandas_full,
                       route_pod_candidates)

_F = torch.float32


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no card and no explicit request this raises; it never
    falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters."""

    T: int = 20_000               # total slots
    warmup: int = 4_000           # slots discarded before measuring
    a_max: int = 0                # max arrivals per slot (0 = auto from load)
    route_mode: str = "sequential"  # "sequential" | "batched"
    service_dist: str = GEOMETRIC   # "geometric" | "lognormal"
    sigma: float = 1.0              # log-normal shape

    def resolve_a_max(self, lam: float, shape_peak: float = 1.0) -> int:
        """Arrival-buffer width from the peak slot intensity:
        peak + 6*sqrt(peak) + 4 (P(clip) per slot ~1e-9)."""
        if self.a_max > 0:
            return self.a_max
        peak = lam * shape_peak
        return int(math.ceil(peak + 6.0 * math.sqrt(peak) + 4))


class RawSums(NamedTuple):
    """Per-run float32 accumulators."""

    slots: torch.Tensor
    sum_N: torch.Tensor
    sum_N_h1: torch.Tensor
    sum_N_h2: torch.Tensor
    arrivals: torch.Tensor
    clipped: torch.Tensor
    completions: torch.Tensor
    starts: torch.Tensor        # [3] service starts by locality class
    routed: torch.Tensor        # [3] routing decisions by chosen class
    busy: torch.Tensor
    route_decisions: torch.Tensor
    sched_decisions: torch.Tensor
    final_N: torch.Tensor

    @staticmethod
    def zero(device="cpu") -> "RawSums":
        """All-zero accumulator."""
        z = lambda *s: torch.zeros(s, dtype=_F, device=device)
        return RawSums(z(), z(), z(), z(), z(), z(), z(), z(3), z(3), z(),
                       z(), z(), z())


class SimResult(NamedTuple):
    """Per-run summary statistics (``summarize``)."""

    mean_tasks_in_system: torch.Tensor
    mean_completion_slots: torch.Tensor
    mean_completion_norm: torch.Tensor   # units of mean local service time
    arrival_rate_hat: torch.Tensor
    throughput: torch.Tensor
    utilization: torch.Tensor
    locality_fractions: torch.Tensor     # [3] of service starts
    routed_fractions: torch.Tensor       # [3] of routing choices
    drift: torch.Tensor                  # mean_N(2nd half) / mean_N(1st half);
    #                                      NaN when the 1st half saw no mass
    clip_fraction: torch.Tensor
    route_decisions: torch.Tensor
    sched_decisions: torch.Tensor
    route_candidates_per_decision: torch.Tensor
    sched_candidates_per_decision: torch.Tensor


class BPState(NamedTuple):
    """Balanced-Pandas family state: per-server 3-class sub-queues."""

    Q: torch.Tensor          # int32 [M, 3] sub-queue lengths
    busy: torch.Tensor       # bool  [M]
    rem: torch.Tensor        # f32   [M] remaining service work units
    cls: torch.Tensor        # int32 [M] class of the in-service task

    @staticmethod
    def zero(M: int, device="cpu") -> "BPState":
        """Empty cluster of M servers."""
        return BPState(torch.zeros((M, 3), dtype=torch.int32, device=device),
                       torch.zeros(M, dtype=torch.bool, device=device),
                       torch.zeros(M, dtype=_F, device=device),
                       torch.zeros(M, dtype=torch.int32, device=device))


_BP_DTYPES = (torch.int32, torch.bool, torch.float32, torch.int32)


def bp_state_from_numpy(state, device="cpu") -> BPState:
    """A ``BPState`` from four arrays (Q, busy, rem, cls), e.g. the
    reference's state as numpy."""
    return BPState(*(torch.tensor(np.asarray(x), dtype=d, device=device)
                     for x, d in zip(state, _BP_DTYPES)))


def bp_state_to_numpy(state: BPState) -> BPState:
    """The same state with numpy leaves."""
    return BPState(*(x.cpu().numpy() for x in state))


def raw_sums_from_numpy(sums, device="cpu") -> RawSums:
    """``RawSums`` from 13 float32 arrays in field order."""
    return RawSums(*(torch.tensor(np.asarray(x), dtype=_F, device=device)
                     for x in sums))


def raw_sums_to_numpy(sums: RawSums) -> RawSums:
    """The same accumulators with numpy leaves."""
    return RawSums(*(x.cpu().numpy() for x in sums))


# ---------------------------------------------------------------------------
# The random-draw seam
# ---------------------------------------------------------------------------


class SlotDraws(NamedTuple):
    """Every random number one slot of the BP family consumes."""

    raw: torch.Tensor                          # int32 [] Poisson count, unclipped
    locals_: torch.Tensor                      # int32 [A, n_rep] replica triples
    cls: torch.Tensor                          # int32 [A, M] their locality
    #                                            classes (derived from locals_,
    #                                            carried so it is built once)
    dur: torch.Tensor                          # int32 [M, 3] duration per class
    prio: Optional[torch.Tensor] = None        # int32 [M] tie permutation
    #                                            (full BP, batched)
    tie_rnd: Optional[torch.Tensor] = None     # f32 [M] tie priority
    #                                            (full BP, sequential)
    cand_idx: Optional[torch.Tensor] = None    # int32 [A, C] candidates (pod)
    cand_valid: Optional[torch.Tensor] = None  # bool [A, C]
    cand_rnd: Optional[torch.Tensor] = None    # f32 [A, C] tie uniforms
    #                                            (pod, sequential)


class TorchDraws:
    """Default draw source: ``draws(t)`` is slot t's ``SlotDraws``, in the
    reference's distributions, from a ``torch.Generator`` on the device of
    ``lam_t`` ([T] arrival intensity per slot).

    Draws are made for a block of slots at once (up to 256, fewer when a
    slot's [a_max, M] class grid is large) and handed out as views, so a
    slot costs no generator launches of its own.  The full-BP tie
    permutation is the argsort of iid uniforms: a uniform permutation."""

    _BLOCK_ELEMS = 1 << 22      # class-grid elements per block

    def __init__(self, gen: torch.Generator, cluster: Cluster, rates: Rates,
                 cfg: SimConfig, pod: Optional[PodSpec], a_max: int,
                 lam_t: torch.Tensor):
        self.gen, self.cluster, self.cfg, self.pod = gen, cluster, cfg, pod
        self.a_max, self.lam_t = a_max, lam_t
        self.sequential = cfg.route_mode == "sequential"
        self.p = rates.as_array(lam_t.device)                     # [3]
        self.block = max(1, min(256, self._BLOCK_ELEMS // (a_max * cluster.M)))
        if pod is not None:
            self.cand_cls = pod_candidate_classes(cluster.n_replicas, pod,
                                                  lam_t.device)
        self._t0, self._buf = None, None

    def _fill(self, t0: int) -> SlotDraws:
        """Draws for slots t0 .. t0 + block - 1, each field [n, ...]."""
        g, c, M, dev = self.gen, self.cluster, self.cluster.M, self.lam_t.device
        lam = self.lam_t[t0:t0 + self.block]
        n = lam.shape[0]
        raw = torch.poisson(lam, generator=g).to(torch.int32)
        locals_ = sample_locals(g, c, n * self.a_max, dev).view(
            n, self.a_max, -1)
        cls = locality_class(c, locals_)
        if self.cfg.service_dist == GEOMETRIC:
            dur = durations_from_uniform(uniform_open(g, (n, M, 1), dev), self.p)
        elif self.cfg.service_dist == LOGNORMAL:
            z = torch.randn((n, M, 1), generator=g, device=dev)
            dur = durations_from_normal(z, self.p, self.cfg.sigma)
        else:
            raise ValueError(f"unknown service distribution "
                             f"{self.cfg.service_dist!r}")
        extra = {}
        if self.pod is None and self.sequential:
            extra["tie_rnd"] = torch.rand((n, M), generator=g, device=dev)
        elif self.pod is None:
            extra["prio"] = torch.rand((n, M), generator=g, device=dev).argsort(
                dim=1).to(torch.int32)
        else:
            ci, _, cv = pod_candidates(g, c, locals_, cls, self.pod,
                                       cand_cls=self.cand_cls)
            extra.update(cand_idx=ci, cand_valid=cv)
            if self.sequential:
                extra["cand_rnd"] = torch.rand(ci.shape, generator=g,
                                               device=dev)
        return SlotDraws(raw, locals_, cls, dur, **extra)

    def __call__(self, t: int) -> SlotDraws:
        if self._buf is None or not self._t0 <= t < self._t0 + self.block:
            self._t0, self._buf = t, self._fill(t)
        i = t - self._t0
        return SlotDraws(*(None if x is None else x[i] for x in self._buf))


# ---------------------------------------------------------------------------
# Shared slot plumbing
# ---------------------------------------------------------------------------


def _progress_service(busy, rem):
    """Busy servers complete one work unit this slot (unit speeds: the
    uniform scenario).  Returns (busy', rem', completed_mask)."""
    rem = torch.where(busy, rem - 1.0, 0.0)
    completed = busy & (rem <= 0)
    busy = busy & ~completed
    rem = torch.where(busy, rem, 0.0)
    return busy, rem, completed


def _arrival_batch(draws: SlotDraws, a_max: int):
    """Arrival mask (Poisson count clipped to a_max), per-server locality
    classes of the arrivals and the clipped count."""
    n = torch.clamp_max(draws.raw, a_max)
    mask = torch.arange(a_max, device=n.device) < n
    return mask, draws.cls, (draws.raw - n).to(_F)


def _acc(sums: RawSums, *, in_half2: bool, N, arr, clipped, comp, starts,
         routed, busy_n, routes, scheds, measure: bool) -> RawSums:
    """Add one slot to the accumulators.  ``measure`` and ``in_half2`` are
    0/1 weights, so every weighted increment is exact and a skipped add
    equals the reference's add of 0.0: the sums match its f32 values bit
    for bit.  All fields update in one packed add."""
    if not measure:
        return sums._replace(final_N=N)
    zero = torch.zeros_like(N)
    inc = torch.cat([torch.stack([
        torch.ones_like(N), N, zero if in_half2 else N, N if in_half2 else zero,
        arr, clipped, comp]), starts, routed,
        torch.stack([busy_n, routes, scheds])])
    cur = torch.cat([torch.stack(sums[:7]), sums.starts, sums.routed,
                     torch.stack(sums[9:12])])
    new = cur + inc
    return RawSums(*new[:7], new[7:10], new[10:13], *new[13:16], final_N=N)


def _task_work(dur: torch.Tensor) -> torch.Tensor:
    """Float32 work units of freshly started tasks.  On the uniform
    scenario the per-task size multiplier is exp(0) = 1, so the work is
    the sampled duration itself (the size law comes with scenarios)."""
    return dur.to(_F)


def _class_hits(cls: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """bool [N, 3]: row n has a hit at column cls[n] where on[n]."""
    return (cls[:, None] == torch.arange(3, device=cls.device)) & on[:, None]


# ---------------------------------------------------------------------------
# BP family
# ---------------------------------------------------------------------------


def _bp_workload(Q: torch.Tensor, inv_rates: torch.Tensor) -> torch.Tensor:
    """Paper §IV-A: W_m = Q^l/alpha_m + Q^k/beta_m + Q^r/gamma_m;
    non-finite (dead) entries contribute 0."""
    inv = inv_rates[None, :] if inv_rates.ndim == 1 else inv_rates
    return workload(Q, torch.where(torch.isfinite(inv), inv, 0.0))


def _bp_schedule(dur, Q, busy, rem, cls):
    """Idle servers start their own head-of-class task: local > rack >
    remote (purely local information, paper §IV-A).  ``dur`` [M, 3] holds
    each server's duration for each class.  Returns (Q', busy', rem',
    cls', starts_by_class [3], n_started)."""
    has = Q > 0
    pick = torch.argmax(has.to(torch.uint8), dim=1)         # first nonempty
    start = ~busy & has.any(dim=1)
    taken = _class_hits(pick, start)
    Q = Q - taken.to(torch.int32)
    d = torch.gather(dur, 1, pick[:, None])[:, 0]
    busy = busy | start
    rem = torch.where(start, _task_work(d), rem)
    cls = torch.where(start, pick.to(torch.int32), cls)
    return Q, busy, rem, cls, taken.sum(dim=0).to(_F), start.sum().to(_F)


def _bp_route_batch(draws: SlotDraws, Q, cls_arr, mask, inv_rates, pod,
                    sequential: bool, class_tiebreak: bool = True,
                    cand_cls: Optional[torch.Tensor] = None):
    """Route a slot's arrival batch; returns (Q', sel [A], sel_cls [A]).

    batched: one ``route_commit`` launch (sequential commits inside the
    batch; ties by class, then ``draws.prio`` / candidate slot).
    sequential: per-arrival plain routing, each arrival seeing the previous
    one's queues; random ties (``draws.tie_rnd`` / ``draws.cand_rnd``)."""
    if not sequential:
        if pod is None:
            Q, _W, sel, sel_cls, _val = route_commit(
                Q, mask, inv_rates, cls=cls_arr, prio=draws.prio)
        else:
            Q, _W, sel, sel_cls, _val = route_commit(
                Q, mask, inv_rates, cand_idx=draws.cand_idx,
                cand_cls=cand_cls, cand_valid=draws.cand_valid)
        return Q, sel, sel_cls

    # arrivals after the last valid one commit nothing and their decisions
    # are never read (routed counts are masked): route up to that one only.
    # This reads the arrival count on the host, once per slot.
    n = max((b + 1 for b, v in enumerate(mask.tolist()) if v), default=0)
    Q = Q.clone()
    sel = torch.zeros(mask.shape[0], dtype=torch.int32, device=Q.device)
    sel_cls = torch.zeros_like(sel)
    for b in range(n):
        W = _bp_workload(Q, inv_rates)
        if pod is None:
            s, c = route_balanced_pandas_full(W, cls_arr[b], inv_rates,
                                              draws.tie_rnd, class_tiebreak)
        else:
            s, c = route_pod_candidates(draws.cand_rnd[b], W,
                                        draws.cand_idx[b], cand_cls[b],
                                        draws.cand_valid[b], inv_rates)
        Q.index_put_((s.to(torch.int64), c.to(torch.int64)),
                     mask[b].to(torch.int32), accumulate=True)
        sel[b], sel_cls[b] = s, c
    return Q, sel, sel_cls


def _bp_step(state: BPState, sums: RawSums, draws: SlotDraws, *,
             cluster: Cluster, cfg: SimConfig, inv_rate_m: torch.Tensor,
             pod: Optional[PodSpec], a_max: int, measure: bool,
             in_half2: bool, class_tiebreak: bool = True,
             cand_cls: Optional[torch.Tensor] = None):
    """One slot of the BP family on the homogeneous (uniform) path:
    completions -> scheduling -> arrivals and routing -> accumulators.
    ``cand_cls`` ([A, C] int32, pod only) may be passed precomputed."""
    if pod is not None and cand_cls is None:
        cand_cls = pod_candidate_classes(cluster.n_replicas, pod,
                                         state.Q.device).expand(
            a_max, -1).contiguous()
    busy, rem, completed = _progress_service(state.busy, state.rem)
    Q, busy, rem, cls_serv, starts, n_started = _bp_schedule(
        draws.dur, state.Q, busy, rem, state.cls)
    mask, cls_arr, clipped = _arrival_batch(draws, a_max)
    Q, sel, sel_cls = _bp_route_batch(
        draws, Q, cls_arr, mask, inv_rate_m, pod,
        sequential=(cfg.route_mode == "sequential"),
        class_tiebreak=class_tiebreak, cand_cls=cand_cls)

    routed = _class_hits(sel_cls, mask).sum(dim=0).to(_F)
    busy_n = busy.sum().to(_F)
    N = Q.sum().to(_F) + busy_n
    arr = mask.sum().to(_F)
    sums = _acc(sums, in_half2=in_half2, N=N, arr=arr, clipped=clipped,
                comp=completed.sum().to(_F), starts=starts, routed=routed,
                busy_n=busy_n, routes=arr, scheds=n_started, measure=measure)
    return BPState(Q, busy, rem, cls_serv), sums


# ---------------------------------------------------------------------------
# Algorithm registry + entry point
# ---------------------------------------------------------------------------

# paper §V: d = 8 = (2 rack-local + 6 remote) for BP-Pod routing
BP_POD_DEFAULT = PodSpec(d_rack=2, d_remote=6)

ALGORITHMS = ("balanced_pandas", "balanced_pandas_pod")
_BP_ALGOS = ("balanced_pandas", "balanced_pandas_pod",
             "balanced_pandas_randomtie")
_LATER = ("fcfs", "jsq_priority", "jsq_maxweight", "jsq_maxweight_pod")


def _check_algo(algo: str) -> None:
    if algo in _LATER:
        raise NotImplementedError(
            f"{algo!r} is not ported yet: the SQ and FCFS families come "
            "with ROADMAP queue A, item 4")
    if algo not in _BP_ALGOS:
        raise ValueError(f"unknown algorithm {algo!r}")


def _pod_for(algo: str, pod: Optional[PodSpec]) -> Optional[PodSpec]:
    if pod is not None:
        return pod
    if algo == "balanced_pandas_pod":
        return BP_POD_DEFAULT
    return None


DrawSource = Callable[[int], SlotDraws]      # slot index -> that slot's draws


def _run(draw: DrawSource, dev: torch.device, *, algo: str, cluster: Cluster,
         rates: Rates, cfg: SimConfig, pod: Optional[PodSpec],
         a_max: int) -> RawSums:
    """The T-slot loop; returns the raw accumulators."""
    half2_from = cfg.warmup + (cfg.T - cfg.warmup) // 2
    inv = safe_inv_rates(rates.as_array(dev))
    cand_cls = None
    if pod is not None:
        cand_cls = pod_candidate_classes(cluster.n_replicas, pod, dev).expand(
            a_max, -1).contiguous()
    state, sums = BPState.zero(cluster.M, dev), RawSums.zero(dev)
    for t in range(cfg.T):
        state, sums = _bp_step(
            state, sums, draw(t), cluster=cluster,
            cfg=cfg, inv_rate_m=inv, pod=pod, a_max=a_max,
            measure=t >= cfg.warmup, in_half2=t >= half2_from,
            class_tiebreak=(algo != "balanced_pandas_randomtie"),
            cand_cls=cand_cls)
    return sums


def simulate(algo: str, cluster: Cluster, rates: Rates, load: float,
             key, cfg: SimConfig = SimConfig(),
             pod: Optional[PodSpec] = None, scenario=None,
             a_max: Optional[int] = None, *, device=None,
             draws: Optional[DrawSource] = None) -> SimResult:
    """Run one simulation and return derived metrics.

    load: fraction of the capacity edge (lambda = load * M * alpha on the
    uniform scenario).  key: an int seed or a ``torch.Generator`` on
    ``device``.  device: None runs on the CUDA card (and raises without
    one); pass "cpu" to run on the CPU.  draws: a draw source replacing the
    default ``TorchDraws``: a callable from slot index to ``SlotDraws``."""
    _check_algo(algo)
    dev = resolve_device(device)
    scen, lam_cap = realize(scenario, cluster, rates, cfg.T, device=dev)
    lam = float(load) * lam_cap
    pod = _pod_for(algo, pod)
    if a_max is None:
        a_max = cfg.resolve_a_max(lam, float(scen.lam_shape.max()))
    if draws is None:
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(key))
        lam_t = torch.tensor(lam, dtype=_F, device=dev) * scen.lam_shape
        draws = TorchDraws(gen, cluster, rates, cfg, pod, a_max, lam_t)
    sums = _run(draws, dev, algo=algo, cluster=cluster, rates=rates, cfg=cfg,
                pod=pod, a_max=a_max)
    return summarize(sums, algo, cluster, rates, pod)


def summarize(s: RawSums, algo: str, cluster: Cluster, rates: Rates,
              pod: Optional[PodSpec]) -> SimResult:
    """Reduce raw sums to a ``SimResult`` (Little's-law mean delay,
    locality fractions, drift, clip fraction, probe complexity)."""
    _check_algo(algo)
    slots = torch.clamp_min(s.slots, 1.0)
    mean_N = s.sum_N / slots
    lam_hat = s.arrivals / slots
    mean_T = mean_N / torch.clamp_min(lam_hat, 1e-9)
    h = torch.clamp_min(slots / 2.0, 1.0)
    starts_total = torch.clamp_min(s.starts.sum(-1, keepdim=True), 1.0)
    routed_total = torch.clamp_min(s.routed.sum(-1, keepdim=True), 1.0)
    route_cand = bp_candidates_per_route(cluster, pod)
    sched_cand = 1  # own sub-queues only — purely local information
    f = lambda x: torch.tensor(float(x), dtype=_F, device=slots.device)
    return SimResult(
        mean_tasks_in_system=mean_N,
        mean_completion_slots=mean_T,
        mean_completion_norm=mean_T * rates.alpha,
        arrival_rate_hat=lam_hat,
        throughput=s.completions / slots,
        utilization=s.busy / (slots * cluster.M),
        locality_fractions=s.starts / starts_total,
        routed_fractions=s.routed / routed_total,
        drift=torch.where(s.sum_N_h1 > 0,
                          (s.sum_N_h2 / h) / torch.clamp_min(s.sum_N_h1 / h,
                                                             1e-30),
                          float("nan")),
        clip_fraction=s.clipped / torch.clamp_min(s.arrivals + s.clipped, 1.0),
        route_decisions=s.route_decisions,
        sched_decisions=s.sched_decisions,
        route_candidates_per_decision=f(route_cand),
        sched_candidates_per_decision=f(sched_cand),
    )
