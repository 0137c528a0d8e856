"""Correlated-failure window generators.

Copy of ``repro.scenarios.generators`` (numpy, on the host).

Real fleets do not fail one server at a time: a PDU trip or a bad rollout
takes out a whole pod at once, and a single straggling server backs up its
rack's top-of-rack switch so every *rack-local* transfer through it slows
down.  These generators author such patterns as plain ``WindowSpec`` tuples
— nothing downstream (realization, canonical padding, the one-compile
sweep) knows or cares that a window list came from a generator rather than
being written by hand.

Both are deterministic in their ``seed`` (host-side numpy rng; no jax
keys), and cluster-agnostic the same way hand-written windows are: they
speak in rack ids and rack-member indices, which ``build._window_mask``
resolves against the concrete cluster at realization time.
"""
from __future__ import annotations

import numpy as np

from .spec import WindowSpec


def _power_law_durations(rng: np.random.Generator, n: int, alpha: float,
                         dur_min: float, dur_max: float) -> np.ndarray:
    """n Pareto(alpha)-distributed durations (fractions of T), clipped.

    Inversion sampling: dur = dur_min * (1 - u)^(-1/alpha) — the standard
    heavy-tailed outage-length model (most blips are short, a few windows
    run long)."""
    u = rng.random(n)
    return np.minimum(dur_min * (1.0 - u) ** (-1.0 / alpha), dur_max)


def correlated_outages(*, n_events: int, n_racks: int, seed: int,
                       alpha: float = 1.2, dur_min: float = 0.02,
                       dur_max: float = 0.20,
                       t_range: tuple = (0.10, 0.90)) -> tuple:
    """Whole-pod failures with power-law durations.

    Each event drains one rack completely (``mult=0.0`` — the correlated
    analogue of ``rack_outage``): onset uniform in ``t_range``, duration
    Pareto(``alpha``) between ``dur_min`` and ``dur_max`` fractions of the
    run, rack uniform among the first ``n_racks`` racks (use the smallest
    rack count of the presets the scenario must run on).  Deterministic in
    ``seed``; events may overlap — overlapping windows on the same rack
    compose multiplicatively, and 0 * anything is still an outage.
    """
    rng = np.random.default_rng(seed)
    racks = rng.integers(0, n_racks, n_events)
    t0 = rng.uniform(t_range[0], t_range[1], n_events)
    dur = _power_law_durations(rng, n_events, alpha, dur_min, dur_max)
    return tuple(
        WindowSpec(t0=float(t0[e]), t1=float(min(t0[e] + dur[e], 1.0)),
                   mult=0.0, rack=int(racks[e]))
        for e in range(n_events))


def cascading_stragglers(*, n_events: int, n_racks: int, seed: int,
                         straggler_mult: float = 0.25,
                         beta_mult: float = 0.5,
                         dur_min: float = 0.10, dur_max: float = 0.25,
                         t_range: tuple = (0.15, 0.75)) -> tuple:
    """A slow server degrades its rack's beta tier via the shared ToR.

    Each event emits TWO windows over the same interval: the straggler
    itself (one rack member, whole-server ``straggler_mult`` — its disk or
    host NIC is sick, so every tier it serves slows), and the *cascade* —
    the rest of the story a whole-server model cannot tell: the straggler's
    retransmissions sit on the rack's shared ToR uplinks, so every server
    in that rack serves rack-local (beta) traffic at ``beta_mult`` while
    local and remote tiers are untouched (``mult=(1, beta_mult, 1)`` — a
    per-class window).  The straggler is addressed as a (rack, member)
    pair, resolved against the concrete cluster at realization.
    """
    rng = np.random.default_rng(seed)
    windows = []
    for _ in range(n_events):
        rack = int(rng.integers(0, n_racks))
        member = int(rng.integers(0, 1 << 16))    # mod rack_size at realize
        t0 = float(rng.uniform(t_range[0], t_range[1]))
        t1 = float(min(t0 + rng.uniform(dur_min, dur_max), 1.0))
        windows.append(WindowSpec(t0=t0, t1=t1, mult=straggler_mult,
                                  rack_member=(rack, member)))
        windows.append(WindowSpec(t0=t0, t1=t1,
                                  mult=(1.0, beta_mult, 1.0), rack=rack))
    return tuple(windows)
