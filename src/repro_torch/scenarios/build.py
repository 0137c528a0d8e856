"""Scenario realization for the port: the ``uniform`` scenario only.

Mirror of the part of ``repro.scenarios.build`` that the paper's experiment
needs: a stationary arrival shape, unit server speeds, no event windows and
uniform replica placement.  The other registry scenarios (heterogeneous
fleets, traffic shapes, skewed placement) and the canonical sweep padding
come with a later slice of the port (ROADMAP queue A, item 3).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.cluster import Cluster, Rates


class ScenarioData(NamedTuple):
    """Realized scenario arrays.

    lam_shape   [T] float32 arrival-intensity shape (ones: stationary)
    base_speed  [M] float32 per-server speed multipliers (ones: symmetric)
    """

    lam_shape: torch.Tensor
    base_speed: torch.Tensor

    @property
    def M(self) -> int:
        """Number of servers this realization was built for."""
        return self.base_speed.shape[0]


def realize(scenario, cluster: Cluster, rates: Rates, T: int, pad=None, *,
            device="cpu") -> tuple[ScenarioData, float]:
    """``(ScenarioData, lam_cap)`` for ``scenario`` (None or "uniform").

    lam_cap = alpha * M is the capacity edge in tasks per slot: the closed
    form the reference's placement-aware edge returns bit for bit on
    uniform placement with unit speeds.  ``pad`` is the reference's
    canonical sweep padding: only None is ported."""
    name = getattr(scenario, "name", scenario)
    if name not in (None, "uniform"):
        raise NotImplementedError(
            f"scenario {name!r} is not ported yet: only 'uniform' is "
            "(ROADMAP queue A, item 3)")
    if pad is not None:
        raise NotImplementedError(
            "pad is not ported yet: the canonical sweep padding comes with "
            "the scenarios (ROADMAP queue A, item 3)")
    scen = ScenarioData(
        lam_shape=torch.ones(T, dtype=torch.float32, device=device),
        base_speed=torch.ones(cluster.M, dtype=torch.float32, device=device))
    return scen, rates.alpha * cluster.M
