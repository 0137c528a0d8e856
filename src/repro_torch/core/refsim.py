"""Event-accurate numpy reference simulator (the oracle for tests; a copy
of ``repro.core.refsim`` over the port's ``Cluster`` / ``Rates``, run on
the host by design).

Tracks every task individually (arrival slot -> service completion slot), so
mean completion time is measured directly per task rather than via Little's
law.  Deliberately simple and slow — plain Python over numpy state — and
structured exactly like the paper's §IV-A Balanced-Pandas(-Pod) description:
per-arrival routing, per-server FIFO sub-queues, local>rack>remote service.

The simulator's Little's-law estimate must agree with this direct
measurement within sampling error, on the uniform fleet and on a
heterogeneous one (per-server speeds: ``simulate_bp_ref``'s ``speed``).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .cluster import Cluster, Rates

LOCAL, RACK, REMOTE = 0, 1, 2


@dataclasses.dataclass
class RefResult:
    """Summary of one event-accurate reference run (oracle for tests)."""
    mean_completion_slots: float
    mean_tasks_in_system: float
    n_completed: int
    locality_fractions: np.ndarray
    sojourns: np.ndarray | None = None   # exact per-task sojourn slots
    throughput: float = 0.0   # ALL completions per measured slot (incl.
    #                           pre-warmup arrivals) — in overload this
    #                           saturates at the capacity edge, the signal
    #                           the brute-force LP oracle probes


def _locality(cluster: Cluster, locals_: np.ndarray) -> np.ndarray:
    R = cluster.rack_size
    cls = np.full(cluster.M, REMOTE, np.int32)
    racks = np.unique(locals_ // R)
    for r in racks:
        cls[r * R:(r + 1) * R] = RACK
    cls[locals_] = LOCAL
    return cls


def simulate_bp_ref(cluster: Cluster, rates: Rates, load: float, T: int,
                    warmup: int, seed: int, d_rack: int = 0,
                    d_remote: int = 0, pod: bool = False,
                    speed: np.ndarray | None = None,
                    placement: tuple | None = None) -> RefResult:
    """Balanced-Pandas (pod=False) or Balanced-Pandas-Pod (pod=True).

    placement: optional ``(probs [C], locals [C, n_replicas])`` skewed
    catalog (the scenario engine's Zipf/adversarial placement axis): each
    arrival draws a chunk from ``probs`` and uses its fixed replica triple
    instead of sampling servers uniformly.  ``lam`` stays
    ``load * alpha * sum(local speed)`` — the FLEET edge — so probing
    ``load`` above the fluid-LP edge over-drives the system and the
    measured ``throughput`` saturates at the true (placement-aware)
    capacity: the brute-force oracle tests/test_capacity.py checks the LP
    against.  None keeps the historical uniform sampling bit-for-bit.

    speed: optional per-server speed multipliers (constant in time) — the
    heterogeneous-fleet model of repro.scenarios: [M] whole-server, or
    [M, 3] per locality class (per-tier degradation windows).  Durations
    are sampled in speed-1 work units at the class rate, a busy server m
    completes speed[m, c] units per slot for its in-flight class-c task,
    and the workload metric / routing scores use each server's own [M, 3]
    rates, with zero-rate entries carried as +inf inverse rates (the
    kernels' contract: 0 workload contribution, +inf routing score).
    None == all ones == the symmetric model.  The capacity edge matches
    the scenario engine: lam = load * alpha * sum(local speed)."""
    rng = np.random.default_rng(seed)
    M = cluster.M
    inv = 1.0 / np.array([rates.alpha, rates.beta, rates.gamma])
    if speed is None:
        speed = np.ones(M)
    speed = np.asarray(speed, np.float64)
    if speed.ndim == 1:
        speed = np.repeat(speed[:, None], 3, axis=1)
    # per-server reciprocal rates; +inf for drained (zero-rate) tiers
    inv_m = np.where(speed > 0, inv[None, :] / np.maximum(speed, 1e-12),
                     np.inf)
    inv_m_w = np.where(np.isfinite(inv_m), inv_m, 0.0)   # workload weights
    lam = load * rates.alpha * speed[:, 0].sum()

    queues = [[[], [], []] for _ in range(M)]   # arrival slots, FIFO
    Q = np.zeros((M, 3), np.int64)
    busy = np.zeros(M, bool)
    rem = np.zeros(M, np.float64)               # remaining work units
    serving_cls = np.zeros(M, np.int64)         # class of in-service task
    started_at = np.zeros(M, np.int64)          # arrival slot of in-service task
    sojourns: list[int] = []
    start_cls_counts = np.zeros(3, np.int64)
    sum_N = 0.0
    n_slots_measured = 0
    n_done_measured = 0
    if placement is not None:
        p_probs = np.asarray(placement[0], np.float64)
        p_probs = p_probs / p_probs.sum()
        p_locals = np.asarray(placement[1], np.int64)

    for t in range(T):
        # completions
        rem[busy] -= speed[np.arange(M), serving_cls][busy]
        done = busy & (rem <= 0)
        if t >= warmup:
            n_done_measured += int(done.sum())
        for m in np.where(done)[0]:
            if t >= warmup and started_at[m] >= warmup:
                sojourns.append(t - started_at[m])
        busy &= ~done

        # scheduling: own queues, first servable class local > rack > remote
        # (a drained tier is skipped; a fully drained server starts nothing)
        for m in np.where(~busy & (speed > 0).any(axis=1))[0]:
            for c in range(3):
                if queues[m][c] and speed[m, c] > 0:
                    arr_slot = queues[m][c].pop(0)
                    Q[m, c] -= 1
                    busy[m] = True
                    serving_cls[m] = c
                    started_at[m] = arr_slot
                    p = 1.0 / inv[c]
                    rem[m] = rng.geometric(p)
                    if t >= warmup:
                        start_cls_counts[c] += 1
                    break

        # arrivals
        for _ in range(rng.poisson(lam)):
            if placement is not None:
                locals_ = p_locals[rng.choice(len(p_probs), p=p_probs)]
            else:
                locals_ = rng.choice(M, size=cluster.n_replicas,
                                     replace=False)
            cls = _locality(cluster, locals_)
            W = (Q * inv_m_w).sum(axis=1)
            if pod:
                cand = list(locals_)
                rack_set = np.where(cls == RACK)[0]
                rem_set = np.where(cls == REMOTE)[0]
                if len(rack_set) and d_rack:
                    cand += list(rng.choice(rack_set, size=d_rack))
                if len(rem_set) and d_remote:
                    cand += list(rng.choice(rem_set, size=d_remote))
                cand = np.array(cand)
            else:
                cand = np.arange(M)
            ic = inv_m[cand, cls[cand]]
            # +inf contract: dead candidates score +inf after the multiply
            ww = np.where(np.isfinite(ic), W[cand] * ic, np.inf)
            # ties: faster class, then random
            best = ww.min()
            tied = cand[ww == best]
            tied = tied[cls[tied] == cls[tied].min()]
            m = rng.choice(tied)
            c = int(cls[m])
            queues[m][c].append(t)
            Q[m, c] += 1

        if t >= warmup:
            sum_N += Q.sum() + busy.sum()
            n_slots_measured += 1

    return RefResult(
        mean_completion_slots=float(np.mean(sojourns)) if sojourns else 0.0,
        mean_tasks_in_system=sum_N / max(n_slots_measured, 1),
        n_completed=len(sojourns),
        locality_fractions=start_cls_counts / max(start_cls_counts.sum(), 1),
        sojourns=np.asarray(sojourns, np.int64),
        throughput=n_done_measured / max(n_slots_measured, 1),
    )
