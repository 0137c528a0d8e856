"""Request routing for a serving fleet (mirror of ``repro.sched``):
``PodRouter`` over the card's ``route_commit`` kernel, the fleet locality
model, and the host-side ``ShardBalancer``."""
from .locality import FleetTopology, service_rates
from .router import (PodRouter, RouterDraws, RouterStats, SharedDraws,
                     TorchRouterDraws, sample_candidates)
from .straggler import ShardBalancer

__all__ = ["FleetTopology", "PodRouter", "RouterDraws", "RouterStats",
           "ShardBalancer", "SharedDraws", "TorchRouterDraws",
           "sample_candidates", "service_rates"]
