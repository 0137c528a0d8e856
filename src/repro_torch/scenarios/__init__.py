"""Scenario engine: composable axes of heterogeneity (PyTorch mirror of
``repro.scenarios``).

A Scenario is a product of three axis specs (``spec.py``): the fleet (slow
racks, slow cohorts, event windows with per-class multipliers), the traffic
shape (stationary, diurnal, flash crowd, MMPP bursts) and the data
placement (uniform or Zipf over a replica catalog), plus the per-task size
law.  ``compose()`` folds scenarios axis by axis; ``SCENARIOS`` holds the
reference's named registry, in its order, minus the trace-backed
``production_day`` (ROADMAP queue A, item 6).

``realize()`` turns a scenario into tensors on the device (``build.py``):
realization itself runs on the host in numpy, as in the reference, so the
arrays are the reference's bit for bit, and the capacity edge ``lam_cap``
is the reference's closed form or fluid LP (``capacity.py``, scipy).  The
slot loop reads ``speed_at`` and ``sample_locals_scenario``.
``stack_scenarios`` realizes many scenarios against one pad and stacks them
on a leading axis, the input of ``core.simulate_sweep``.
"""
from .spec import (
    COMPOSE_DEPTH,
    SCENARIOS,
    FleetSpec,
    PlacementSpec,
    Scenario,
    SizeSpec,
    TrafficProduct,
    TrafficSpec,
    WindowSpec,
    compose,
    get_scenario,
    register,
    registry_limits,
    scenario_names,
)
from .generators import cascading_stragglers, correlated_outages
from .capacity import capacity_edge, fluid_edge, uniform_edge
from .build import (
    ScenarioData,
    ScenarioPad,
    arrival_counts,
    canonical_a_max,
    canonical_pad,
    capacity_scale,
    placement_epoch_at,
    realize,
    sample_locals_scenario,
    scenario_from_numpy,
    scenario_row,
    speed_at,
    stack_scenarios,
    speed_trace,
    traffic_shape,
)

__all__ = [n for n in dir() if not n.startswith("_")]
