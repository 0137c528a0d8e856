"""Scenario axis specs, the ``compose()`` algebra, and the named registry.

Copy of ``repro.scenarios.spec`` (plain Python): the same specs, the same
registry in the same order, minus the trace-backed ``production_day``
entry, which the trace package registers and which is not ported yet
(``get_scenario("production_day")`` raises ``NotImplementedError``).

A :class:`Scenario` is a product of three independent *axis specs* —
:class:`FleetSpec` (who is slow / down, and when), :class:`TrafficSpec`
(how arrivals breathe), :class:`PlacementSpec` (where the data lives).
Each axis is **mergeable**: ``axis.merge(other)`` combines two specs of the
same axis, and :func:`compose` folds whole scenarios together axis-by-axis:

  fleet      event windows union; persistent rack speeds multiply
             elementwise; slow cohorts accumulate (each drawn
             independently at realization).
  traffic    product of the mean-1 intensity shapes, renormalized to
             mean 1 (a diurnal tide modulating a flash crowd).
  placement  the rightmost non-uniform placement wins (compose does not
             union chunk catalogs).

So ``compose("slow_rack", "flash_crowd")`` is a first-class experiment and
the registry no longer needs a hand-written product scenario per
combination — the shipped products (``hetero_storm``, ``outage_storm``,
``cascade_flash``) are themselves registered compositions.

Window multipliers are per locality class: ``WindowSpec.mult`` is either a
scalar (whole-server slowdown/outage — every tier scales together) or a
3-tuple ``(local, rack, remote)`` scaling each service tier independently,
which expresses network-tier degradation (ICI/DCN congestion slows beta and
gamma service while HBM-local alpha service is untouched) and shared-ToR
cascades.  Generators for correlated failure patterns (whole-pod outages
with power-law durations, cascading stragglers) live in ``generators.py``
and emit plain ``WindowSpec`` tuples, so canonical padding and the
one-compile sweep are oblivious to how a window list was authored.
"""
from __future__ import annotations

import dataclasses
import functools
import math
import operator
from typing import Optional, Union


@dataclasses.dataclass(frozen=True)
class WindowSpec:
    """A time window during which a set of servers changes speed.

    t0/t1 are fractions of the run length T (scenarios are T-agnostic);
    the affected set is a rack, an [lo, hi) server-id interval, every
    f-th server, or a single rack member — whichever selector is not
    None.  ``mult`` multiplies the servers' base speed inside the window
    (0.0 == outage/drain): a scalar applies to all three locality classes
    (whole-server event), a 3-tuple ``(local, rack, remote)`` scales each
    service tier independently (network-tier degradation)."""

    t0: float
    t1: float
    mult: Union[float, tuple]
    rack: Optional[int] = None
    servers: Optional[tuple] = None        # (lo, hi) server-id interval
    every: Optional[int] = None            # servers m with m % every == phase
    phase: int = 0
    rack_member: Optional[tuple] = None    # (rack, i): server rack*R + i % R

    @property
    def class_mult(self) -> tuple:
        """The per-class multiplier triple (scalars broadcast)."""
        if isinstance(self.mult, (int, float)):
            return (float(self.mult),) * 3
        m = tuple(float(x) for x in self.mult)
        if len(m) != 3:
            raise ValueError(f"per-class mult needs 3 entries, got {self.mult}")
        return m


@dataclasses.dataclass(frozen=True)
class FleetSpec:
    """Persistent per-server speeds + transient event windows.

    ``slow_frac``/``slow_mult`` name one random slow cohort (kept as the
    authoring shorthand); ``slow`` carries further ``(frac, mult)`` cohorts
    accumulated by :meth:`merge`.  ``cohorts()`` is the flattened view the
    realizer draws from."""

    rack_speeds: tuple = ()                # per-rack multiplier ((): all 1.0)
    slow_frac: float = 0.0                 # fraction of servers slowed ...
    slow_mult: float = 1.0                 # ... persistently, by this factor
    windows: tuple = ()                    # of WindowSpec
    slow: tuple = ()                       # extra (frac, mult) cohorts

    def cohorts(self) -> tuple:
        """All (fraction, multiplier) slow-cohort pairs, head field first."""
        head = (((self.slow_frac, self.slow_mult),)
                if self.slow_frac > 0.0 and self.slow_mult != 1.0 else ())
        return head + tuple(self.slow)

    @property
    def uniform(self) -> bool:
        """True when the fleet is the paper's homogeneous baseline."""
        return (not self.rack_speeds and not self.windows
                and not self.cohorts())

    def merge(self, other: "FleetSpec") -> "FleetSpec":
        """Union windows, multiply persistent speeds, accumulate cohorts."""
        n = max(len(self.rack_speeds), len(other.rack_speeds))
        a = self.rack_speeds + (1.0,) * (n - len(self.rack_speeds))
        b = other.rack_speeds + (1.0,) * (n - len(other.rack_speeds))
        return FleetSpec(rack_speeds=tuple(x * y for x, y in zip(a, b)),
                         windows=self.windows + other.windows,
                         slow=self.cohorts() + other.cohorts())


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Arrival-intensity shape, normalized to mean 1 at realization."""

    kind: str = "stationary"               # |diurnal|flash|mmpp
    # diurnal: lam(t) = 1 + amp * sin(2 pi * cycles * t / T)
    amp: float = 0.35
    cycles: float = 3.0
    # flash crowd: intensity steps to `peak` x base inside [t0, t1) x T
    t0: float = 0.5
    t1: float = 0.6
    peak: float = 2.5
    # mmpp: 2-state chain, burst state `burst` x the quiet intensity
    burst: float = 3.0
    p_enter: float = 0.003                 # quiet -> burst per slot
    p_exit: float = 0.01                   # burst -> quiet per slot

    @property
    def parts(self) -> tuple:
        """Non-trivial factors of this shape (stationary is the identity)."""
        return () if self.kind == "stationary" else (self,)

    def merge(self, other) -> "Traffic":
        """Compose with another traffic shape (pointwise product)."""
        return _traffic_from_parts(self.parts + other.parts)


@dataclasses.dataclass(frozen=True)
class TrafficProduct:
    """Product of several mean-1 intensity shapes, renormalized to mean 1.

    Produced by composing scenarios with non-trivial traffic on both sides;
    realized by ``build.traffic_shape`` (factors multiply pointwise, then
    one final mean-1 normalization).  Deterministic factors (diurnal /
    flash) compose order-invariantly; stochastic factors (mmpp) consume
    host-rng draws in factor order."""

    factors: tuple                         # of TrafficSpec, each non-trivial

    @property
    def parts(self) -> tuple:
        """The non-trivial factors (already each non-stationary)."""
        return tuple(self.factors)

    def merge(self, other) -> "Traffic":
        """Compose with another traffic shape (factor union)."""
        return _traffic_from_parts(self.parts + other.parts)


Traffic = Union[TrafficSpec, TrafficProduct]


def _traffic_from_parts(parts: tuple) -> Traffic:
    if not parts:
        return TrafficSpec(kind="stationary")
    if len(parts) == 1:
        return parts[0]
    return TrafficProduct(tuple(parts))


@dataclasses.dataclass(frozen=True)
class PlacementSpec:
    """Where chunk replicas live; 'zipf' makes some triples hot.

    ``hot_rack`` pins the replica triples of the most popular catalog rows
    (the top ``hot_frac`` by Zipf rank) entirely inside one rack — the
    adversarial "all hot data on one rack" placement, where locality-blind
    routing must funnel most of the load through K-th of the fleet."""

    kind: str = "uniform"                  # |zipf
    zipf_s: float = 1.2                    # popularity exponent
    chunks_per_server: int = 4             # catalog size C = this * M
    hot_rack: Optional[int] = None         # rack holding all hot replicas
    hot_frac: float = 0.25                 # top fraction of rows pinned

    def merge(self, other: "PlacementSpec") -> "PlacementSpec":
        """Rightmost non-uniform placement wins (catalogs do not union)."""
        return other if other.kind != "uniform" else self


@dataclasses.dataclass(frozen=True)
class SizeSpec:
    """Per-task service-size multiplier law: lognormal, normalized to mean 1.

    ``sigma`` is the log-space standard deviation; the realizer pairs it
    with ``mu = -sigma^2 / 2`` so the multiplier's mean is exactly 1 and
    the capacity-region edge (lam_cap) is size-law invariant.  sigma = 0
    is the exact identity — the simulator's sampled durations are
    untouched bit-for-bit.  The trace->scenario compiler fits sigma from
    observed task sizes; merge composes independent lognormal factors
    (variances add in log space)."""

    sigma: float = 0.0

    @property
    def trivial(self) -> bool:
        """True for unit-size tasks (no size randomness)."""
        return self.sigma == 0.0

    def merge(self, other: "SizeSpec") -> "SizeSpec":
        """Compose lognormal spreads (variances add in log space)."""
        return SizeSpec(sigma=math.sqrt(self.sigma ** 2 + other.sigma ** 2))


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A named bundle of one value per axis (fleet / traffic / placement /
    sizes) — declarative; ``build.realize`` turns it into arrays."""
    name: str
    fleet: FleetSpec = FleetSpec()
    traffic: Traffic = TrafficSpec(kind="stationary")
    placement: PlacementSpec = PlacementSpec()
    sizes: SizeSpec = SizeSpec()
    seed: int = 0                          # host-side realization seed
    description: str = ""


SCENARIOS: dict[str, Scenario] = {}
TRACE_SCENARIOS = ("production_day",)   # the reference's trace-backed entries


def register(s: Scenario) -> Scenario:
    """Add a scenario to the global registry (name must be new)."""
    if s.name in SCENARIOS:
        raise ValueError(f"scenario {s.name!r} already registered")
    SCENARIOS[s.name] = s
    return s


def scenario_names() -> tuple[str, ...]:
    """Registered scenario names, in registration order."""
    return tuple(SCENARIOS)


def compose(*scenarios, name: Optional[str] = None,
            seed: Optional[int] = None,
            description: Optional[str] = None) -> Scenario:
    """Fold scenarios into one, merging each axis (see module docstring).

    Accepts registered names or Scenario objects.  Fleet windows union and
    persistent speeds multiply (order-invariant); traffic shapes multiply
    (order-invariant for deterministic shapes); placement is rightmost-
    non-uniform-wins (order matters only when several sides are skewed).
    ``seed`` defaults to the XOR of the parts' seeds — so composing with a
    seed-0 axis scenario preserves the other side's realization draws —
    and ``name`` to the parts' names joined with ``+`` (the spelling the
    benchmark ``--scenarios=`` filter accepts for ad-hoc compositions).

    Canonical-padding note: ``registry_limits`` reserves window slots for
    compositions of up to two registry scenarios (``COMPOSE_DEPTH``), so
    any pairwise ``compose`` realizes to the registry's canonical pytree
    signature.  A 3+-way product of window-carrying scenarios can overflow
    that budget; ``build.realize`` rejects it with a ValueError naming the
    fix — realize with ``build.canonical_pad(cluster, compose_depth=3)``
    (or more) to widen the shared signature for the whole sweep.
    """
    if not scenarios:
        raise ValueError("compose() needs at least one scenario")
    specs = [get_scenario(s) for s in scenarios]
    merged = lambda axis: functools.reduce(
        lambda a, b: a.merge(b), (getattr(s, axis) for s in specs))
    return Scenario(
        name=name or "+".join(s.name for s in specs),
        fleet=merged("fleet"),
        traffic=merged("traffic"),
        placement=merged("placement"),
        sizes=merged("sizes"),
        seed=seed if seed is not None
        else functools.reduce(operator.xor, (s.seed for s in specs)),
        description=description or (
            "composition: " + " x ".join(s.name for s in specs)),
    )


COMPOSE_DEPTH = 2   # pairwise compose() stays on the canonical signature


def registry_limits(scenarios=None,
                    compose_depth: Optional[int] = None
                    ) -> tuple[int, int, int]:
    """Registry-wide shape maxima for canonical pytree padding.

    Returns (max event-window count, max chunks_per_server among non-uniform
    placements — 0 when every scenario places uniformly — and max placement
    churn-epoch count).  build.canonical_pad turns these into concrete array
    shapes so every scenario realizes to the same pytree signature and the
    jit'd simulator compiles once for the whole sweep.

    The window budget is ``compose_depth`` (default ``COMPOSE_DEPTH`` = 2)
    x the largest single count, so a ``compose()`` of up to that many
    registry scenarios — whose windows union — still fits the canonical
    shapes (pads are inert rows; the cost is a few extra [M, 3] multiplier
    rows per scenario).  A 3+-way product of window-carrying scenarios can
    overflow the default budget; pass ``compose_depth=3`` (or more) here /
    to ``build.canonical_pad`` to widen it — ``build.realize`` and
    ``build.stack_scenarios`` name exactly that fix when they reject an
    overflowing composition.  Chunk catalogs and churn epochs need no such
    headroom: placement merge is rightmost-wins, never a union.  Epoch
    counts come from the duck-typed ``n_epochs`` attribute trace-backed
    placements carry (synthetic placements are single-epoch).
    """
    specs = tuple(get_scenario(s) for s in scenarios) \
        if scenarios is not None else tuple(SCENARIOS.values())
    depth = COMPOSE_DEPTH if compose_depth is None else int(compose_depth)
    if depth < 1:
        raise ValueError(f"compose_depth must be >= 1, got {depth}")
    n_windows = depth * max(
        (len(s.fleet.windows) for s in specs), default=0)
    chunks = max((s.placement.chunks_per_server for s in specs
                  if s.placement.kind != "uniform"), default=0)
    epochs = max((getattr(s.placement, "n_epochs", 1) for s in specs),
                 default=1)
    return n_windows, chunks, epochs


def get_scenario(s: Union[str, Scenario, None]) -> Scenario:
    """Resolve a name / Scenario / None (-> uniform baseline) to a Scenario."""
    if s is None:
        return SCENARIOS["uniform"]
    if isinstance(s, Scenario):
        return s
    if s in TRACE_SCENARIOS:
        raise NotImplementedError(
            f"scenario {s!r} is trace-backed: the trace package is not "
            "ported yet (ROADMAP queue A, item 6)")
    try:
        return SCENARIOS[s]
    except KeyError:
        raise KeyError(f"unknown scenario {s!r}; "
                       f"registered: {sorted(SCENARIOS)}") from None


# ---------------------------------------------------------------------------
# The named registry.  `uniform` reproduces the seed simulator exactly; each
# base scenario breaks ONE axis; the product scenarios at the bottom are
# compose()d from the axis entries instead of re-spelling them.
# ---------------------------------------------------------------------------

register(Scenario(
    "uniform",
    description="the paper's symmetric baseline: equal speeds, stationary "
                "Poisson, uniform replica placement"))

register(Scenario(
    "slow_rack",
    fleet=FleetSpec(rack_speeds=(0.5,)),   # rack 0 at half speed, rest 1.0
    description="one rack persistently at half speed (heterogeneous-server "
                "baseline; GB-PANDAS's motivating asymmetry)"))

register(Scenario(
    "straggler_wave",
    fleet=FleetSpec(windows=(
        WindowSpec(t0=0.20, t1=0.40, mult=0.25, every=10, phase=0),
        WindowSpec(t0=0.35, t1=0.55, mult=0.25, every=10, phase=3),
        WindowSpec(t0=0.50, t1=0.70, mult=0.25, every=10, phase=6),
        WindowSpec(t0=0.65, t1=0.85, mult=0.25, every=10, phase=9),
    )),
    description="overlapping straggler cohorts: every 10th server drops to "
                "quarter speed, onset staggered, each recovering"))

register(Scenario(
    "rack_outage",
    fleet=FleetSpec(windows=(
        WindowSpec(t0=0.45, t1=0.55, mult=0.0, rack=0),)),
    description="rack 0 drains completely for 10% of the run, then "
                "recovers (failure window as a zero rate mask)"))

register(Scenario(
    "diurnal_burst",
    traffic=TrafficSpec(kind="diurnal", amp=0.35, cycles=3.0),
    description="sinusoidal arrival intensity, +/-35% around the mean over "
                "3 cycles (diurnal load)"))

register(Scenario(
    "flash_crowd",
    traffic=TrafficSpec(kind="flash", t0=0.5, t1=0.6, peak=2.5),
    description="stationary arrivals with a 2.5x step for 10% of the run "
                "(flash crowd / retry storm)"))

register(Scenario(
    "mmpp_bursty",
    traffic=TrafficSpec(kind="mmpp", burst=3.0, p_enter=0.003, p_exit=0.01),
    description="Markov-modulated Poisson: random bursts at 3x the quiet "
                "intensity (bursty production traffic)"))

register(Scenario(
    "zipf_hotspot",
    placement=PlacementSpec(kind="zipf", zipf_s=1.2),
    description="Zipf(1.2) chunk popularity: a few replica triples receive "
                "most of the tasks (hot data)"))

register(Scenario(
    "adversarial_placement",
    placement=PlacementSpec(kind="zipf", zipf_s=1.2, hot_rack=0,
                            hot_frac=0.25),
    description="adversarial placement: every hot chunk's replica triple "
                "lives entirely on rack 0, so locality-aware routing "
                "funnels most of the load through one rack while the rest "
                "of the fleet only sees remote (gamma) service"))

# -- per-class (network-tier) degradation and correlated failures -----------
# generators.py is imported late so its `from .spec import WindowSpec` sees
# the classes above while this module is still initializing (no cycle).
from .generators import cascading_stragglers, correlated_outages  # noqa: E402

register(Scenario(
    "network_degraded",
    fleet=FleetSpec(windows=(
        WindowSpec(t0=0.30, t1=0.70, mult=(1.0, 0.4, 0.25), every=1),)),
    description="ICI/DCN congestion: rack-local (beta) and remote (gamma) "
                "tiers drop to 40%/25% fleet-wide for the middle of the "
                "run; local (alpha) service is untouched"))

register(Scenario(
    "pod_flap",
    fleet=FleetSpec(windows=correlated_outages(n_events=3, n_racks=4,
                                               seed=101)),
    description="correlated whole-pod failures: rack-wide outages with "
                "power-law durations (host-seeded generator)"))

register(Scenario(
    "tor_cascade",
    fleet=FleetSpec(windows=cascading_stragglers(n_events=2, n_racks=4,
                                                 seed=202)),
    description="cascading stragglers: a slow server drags its whole "
                "rack's beta tier down through the shared ToR"))

# -- product scenarios: compositions of the axis entries above --------------

register(compose(
    "slow_rack",
    Scenario("storm_wave", fleet=FleetSpec(windows=(
        WindowSpec(t0=0.30, t1=0.50, mult=0.25, every=10, phase=0),))),
    Scenario("storm_tide", traffic=TrafficSpec(kind="diurnal", amp=0.30,
                                               cycles=3.0)),
    Scenario("storm_data", placement=PlacementSpec(kind="zipf", zipf_s=1.1)),
    name="hetero_storm",
    description="all three axes at once: slow rack + straggler cohort + "
                "diurnal traffic + Zipf placement"))

register(compose(
    "pod_flap", "mmpp_bursty",
    name="outage_storm",
    description="correlated pod failures during bursty (MMPP) traffic"))

register(compose(
    "tor_cascade", "flash_crowd", "zipf_hotspot",
    name="cascade_flash",
    description="shared-ToR straggler cascade under a flash crowd on hot "
                "(Zipf) data"))
