"""Straggler mitigation for the training fleet, built on the paper's core
(copy of ``repro.sched.straggler``).

The balancer is plain numpy on the host by design, in the reference as
here: a coordinator makes one small decision per shard and keeps its
worker table in host memory.  It is not a CPU fallback of a device path.

At 1000+ nodes, per-step data-shard assignment is a load-balancing problem
with locality: a worker that already holds a shard in host RAM / local
disk is "local", same-pod workers can fetch it over ICI ("rack-local"),
anyone else pulls from the FS ("remote").  A straggling worker is exactly
a low-service-rate server, which is the paper's heterogeneous-server
setting — so the re-balancer *is* Balanced-Pandas-Pod with per-worker
effective workloads W_m scaled by measured worker speed.

O(1) probes per assignment matter here: the coordinator makes
(microbatches x steps) decisions and at fleet scale an O(M) scan per
decision is the scheduler bottleneck the paper quantifies (§IV-C).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class WorkerState:
    speed_ema: float = 1.0     # relative throughput (1.0 == healthy)
    backlog: float = 0.0       # outstanding work, in unit-shard cost


class ShardBalancer:
    """Assign data shards to workers each step, avoiding stragglers."""

    def __init__(self, n_workers: int, n_pods: int, d: int = 8,
                 replication: int = 3, ema: float = 0.3, seed: int = 0):
        self.n = n_workers
        self.pod_of = np.arange(n_workers) // max(n_workers // n_pods, 1)
        self.d = d
        self.replication = replication
        self.ema = ema
        self.workers = [WorkerState() for _ in range(n_workers)]
        self.rng = np.random.default_rng(seed)
        self.reassignments = 0
        self.decisions = 0
        self.probes = 0

    def observe(self, worker: int, step_time: float, expected: float):
        """Update the speed EMA from a measured step time."""
        speed = expected / max(step_time, 1e-9)
        w = self.workers[worker]
        w.speed_ema = (1 - self.ema) * w.speed_ema + self.ema * speed

    def _workload(self, w: WorkerState, cls: int) -> float:
        # shard-fetch penalty by locality class (local/ici/fs), then divide
        # by measured speed: a straggler's queue "looks longer".
        fetch = (1.0, 1.5, 3.0)[cls]
        return (w.backlog + fetch) / max(w.speed_ema, 1e-3)

    def assign(self, shard_homes: np.ndarray) -> int:
        """Route one shard; shard_homes: replica ids that host it locally.
        Returns the chosen worker (power-of-d over locals + sampled)."""
        locals_ = np.asarray(shard_homes)
        pods = np.unique(self.pod_of[locals_])
        cand = list(locals_)
        ccls = [0] * len(cand)
        rack_pool = np.where(np.isin(self.pod_of, pods))[0]
        rack_pool = rack_pool[~np.isin(rack_pool, locals_)]
        rem_pool = np.where(~np.isin(self.pod_of, pods))[0]
        if len(rack_pool):
            cand += list(self.rng.choice(rack_pool, size=min(2, len(rack_pool))))
            ccls += [1] * min(2, len(rack_pool))
        if len(rem_pool):
            k = min(self.d - 2, len(rem_pool))
            cand += list(self.rng.choice(rem_pool, size=k))
            ccls += [2] * k
        scores = [self._workload(self.workers[c], cl)
                  for c, cl in zip(cand, ccls)]
        pick = int(np.argmin(scores))
        worker = int(cand[pick])
        if ccls[pick] != 0:
            self.reassignments += 1
        self.workers[worker].backlog += (1.0, 1.5, 3.0)[ccls[pick]]
        self.decisions += 1
        self.probes += len(cand)
        return worker

    def drain(self, dt: float = 1.0):
        """Advance simulated time: workers burn backlog at their speed."""
        for w in self.workers:
            w.backlog = max(0.0, w.backlog - dt * w.speed_ema)
