"""Fleet locality model for the scheduler (copy of ``repro.sched.locality``;
plain Python, the port's own ``Cluster`` and ``Rates``).

Maps the paper's {local, rack-local, remote} onto a serving fleet:
  local      — replica whose HBM prefix-cache already holds the request's
               prefix (no fetch; fastest time-to-first-token),
  rack-local — replica in the same pod: the KV prefix can be fetched over
               ICI from a local replica,
  remote     — replica in another pod: fetch over DCN, or recompute prefill.

Service-rate ratios default to measured-order-of-magnitude constants: a
cache-hit decode ramps immediately (alpha), an ICI fetch costs ~ prefix_bytes
/ 50 GB/s (beta), DCN/recompute ~5x that (gamma) — the same alpha>beta>gamma
structure as the paper's Hadoop measurements [19-21].
"""
from __future__ import annotations

import dataclasses

from ..core.cluster import Cluster, Rates


@dataclasses.dataclass(frozen=True)
class FleetTopology:
    """n_replicas model replicas spread over n_pods pods."""

    n_replicas: int
    n_pods: int
    replication: int = 3          # prefix-cache copies per hot prefix

    def as_cluster(self) -> Cluster:
        """The paper-core Cluster object: replicas == servers, pods == racks."""
        return Cluster(M=self.n_replicas, K=self.n_pods,
                       n_replicas=self.replication)

    def pod_of(self, r: int) -> int:
        return r // (self.n_replicas // self.n_pods)


def service_rates(prefix_tokens: int = 2048, decode_tokens: int = 256,
                  tok_per_s_hit: float = 50.0) -> Rates:
    """Per-slot completion probabilities for one request class.

    A slot is 1s of replica decode time.  alpha: pure decode after a cache
    hit; beta: + ICI prefix fetch; gamma: + DCN fetch / prefill recompute.
    Ratios follow the up-to-6x locality penalty of [19-21].
    """
    t_hit = decode_tokens / tok_per_s_hit
    t_ici = t_hit * 2.0
    t_dcn = t_hit * 5.0
    return Rates(alpha=min(0.9, 1.0 / t_hit), beta=min(0.9, 1.0 / t_ici),
                 gamma=min(0.9, 1.0 / t_dcn))
