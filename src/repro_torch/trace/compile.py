"""Lower an ArrivalLog into the scenario algebra (trace -> Scenario).

Copy of ``repro.trace.compile`` (numpy), on the port's own
``scenarios.spec``: the realized arrays equal the reference's bit for bit.

The compiler maps the three trace ingredients onto the three scenario axes
plus the size axis, entirely within the canonical ``ScenarioPad``
signature so trace-backed scenarios ride the one-compile sweep unchanged:

  lam_shape   timestamps binned into the simulator's T-slot grid and
              normalized to mean 1 (:class:`TraceTraffic`) — the load knob
              then scales absolute intensity exactly like synthetic shapes.
  placement   the catalog is derived from OBSERVED chunk ids: each
              placement-churn epoch gets its own catalog segment (churn ==
              the mapping changed, so popularity mass moves to fresh rows),
              sized to fit the canonical ``chunks_per_server * M`` row
              budget.  Within an epoch the most-popular chunks get
              individual rows ("head"); the cold tail is folded into a few
              shared rows by ``chunk_id % n_tail`` (:class:`TracePlacement`).
              Replica triples are drawn per row at realization — placement
              structure comes from the trace, server assignment from the
              scenario seed, exactly like the synthetic Zipf catalog.
  sizes       a mean-1 lognormal is fitted to the observed multipliers
              (sigma = std of log sizes) and threaded into service progress
              via ``ScenarioData.size_mu / size_sigma`` — per-task sizes
              enter the simulator as the law they were drawn from.

Lowering is deterministic: the shape/catalog *structure* depends only on
the log and the row budget, and all random draws (replica triples) come
from the realize() rng chain, so the same trace + seed realizes to a
bit-identical Scenario pytree (tests/test_trace.py guards this)."""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple, Optional, Union

import numpy as np

from ..scenarios.spec import Scenario, SizeSpec, _traffic_from_parts
from .format import ArrivalLog

_TINY = 1e-12         # mass floor: empty rows get ~ -27 logits, never drawn


def _resolve(source) -> ArrivalLog:
    return source() if callable(source) else source


@dataclasses.dataclass(frozen=True, eq=False)
class TraceTraffic:
    """Traffic axis backed by a trace (duck-types TrafficSpec for
    build._shape_one via ``realize_shape``).  ``source`` is an ArrivalLog
    or a zero-arg thunk returning one (thunks keep registry entries lazy:
    the canonical production-day trace synthesizes on first realize)."""

    source: Union[ArrivalLog, Callable[[], ArrivalLog]]
    kind: str = "trace"
    smooth: float = 0.005       # moving-average window as a fraction of T

    @property
    def parts(self) -> tuple:
        """A recorded trace is always a non-trivial traffic factor."""
        return (self,)

    def merge(self, other):
        """Compose with another traffic shape (pointwise product)."""
        return _traffic_from_parts(self.parts + other.parts)

    def realize_shape(self, T: int, rng) -> np.ndarray:
        """[T] raw intensity estimate (no rng consumed — lowering a
        recorded trace is deterministic; traffic_shape normalizes to
        mean 1 downstream).

        The binned counts are themselves one sampling realization of the
        underlying intensity; feeding them to the simulator's Poisson
        arrivals raw would re-Poissonize that noise (a doubly-stochastic
        stream, overdispersed ~2x per slot vs the trace).  A moving
        average of ``smooth`` x T slots estimates the intensity instead —
        wide enough to kill per-slot shot noise, narrow enough (default
        0.5% of the horizon) to preserve diurnal ramps and flash crowds.
        ``smooth=0`` replays the raw counts."""
        del rng
        counts = _resolve(self.source).slot_counts(T).astype(np.float64)
        w = int(round(self.smooth * T))
        if w > 1:
            k = np.ones(w)
            counts = (np.convolve(counts, k, "same")
                      / np.convolve(np.ones(T), k, "same"))
        return counts


class CatalogPlan(NamedTuple):
    """Deterministic catalog structure for one epoch (host-side).

    head_ids   [H] chunk ids with individual rows, most popular first
    n_tail     shared tail rows folding the remaining cold chunks
    row0       this epoch's first global catalog row
    mass       [H + n_tail] f64 task mass per row (sums to epoch mass)
    """

    head_ids: np.ndarray
    n_tail: int
    row0: int
    mass: np.ndarray


def catalog_plan(log: ArrivalLog, budget: int) -> list:
    """Split the ``budget`` catalog rows across churn epochs.

    Rows go epoch-major; each epoch's share is proportional to its row
    budget (equal split, remainder to early epochs).  Within an epoch the
    top chunks by observed count get individual head rows; if the epoch
    has more distinct chunks than rows, 1/8 of its rows become shared
    tail rows (``chunk_id % n_tail``) carrying the leftover mass.
    Structure depends only on (log, budget) — no randomness — so the
    realized catalog and the replay row mapping always agree."""
    E = log.n_epochs
    if budget < E:
        raise ValueError(f"catalog budget {budget} < {E} churn epochs")
    share = [budget // E + (1 if e < budget % E else 0) for e in range(E)]
    epoch = log.epoch_of()
    plans, row0 = [], 0
    for e in range(E):
        rows_e = share[e]
        ids, counts = np.unique(log.chunk[epoch == e], return_counts=True)
        order = np.argsort(-counts, kind="stable")
        ids, counts = ids[order], counts[order]
        if ids.shape[0] <= rows_e:
            head, n_tail = ids, 0
            mass = counts.astype(np.float64)
            mass = np.pad(mass, (0, rows_e - mass.shape[0]))  # empty rows
        else:
            n_tail = max(1, rows_e // 8)
            head = ids[:rows_e - n_tail]
            # tail rows carry the ACTUAL mass their fold receives (the
            # same chunk_id % n_tail mapping arrival_rows applies), so the
            # realized popularity law and the replay row stream agree
            # row-for-row, not just in aggregate
            tail_ids = ids[rows_e - n_tail:]
            tail_counts = counts[rows_e - n_tail:]
            tail_mass = np.bincount((tail_ids % n_tail).astype(np.int64),
                                    weights=tail_counts.astype(np.float64),
                                    minlength=n_tail)
            mass = np.concatenate([
                counts[:rows_e - n_tail].astype(np.float64), tail_mass])
        plans.append(CatalogPlan(head_ids=head, n_tail=n_tail, row0=row0,
                                 mass=mass))
        row0 += rows_e
    return plans


def arrival_rows(log: ArrivalLog, budget: int) -> np.ndarray:
    """[N] int32 global catalog row of every task (the replay engine's
    chunk-id -> catalog lookup; inverse of catalog_plan's layout)."""
    plans = catalog_plan(log, budget)
    epoch = log.epoch_of()
    rows = np.empty(log.n_tasks, np.int32)
    for e, plan in enumerate(plans):
        m = epoch == e
        c = log.chunk[m]
        order = np.argsort(plan.head_ids, kind="stable")
        sorted_ids = plan.head_ids[order]
        pos = np.searchsorted(sorted_ids, c)
        pos = np.minimum(pos, max(sorted_ids.shape[0] - 1, 0))
        if sorted_ids.shape[0]:
            is_head = sorted_ids[pos] == c
            head_row = plan.row0 + order[pos]
        else:
            is_head = np.zeros(c.shape, bool)
            head_row = np.zeros(c.shape, np.int64)
        if plan.n_tail:
            tail_row = (plan.row0 + plan.head_ids.shape[0]
                        + c % plan.n_tail)
        else:
            tail_row = head_row     # head covers every observed chunk
        rows[m] = np.where(is_head, head_row, tail_row).astype(np.int32)
    return rows


@dataclasses.dataclass(frozen=True, eq=False)
class TracePlacement:
    """Placement axis backed by a trace (duck-types PlacementSpec for
    build._placement_arrays via ``realize_catalog``)."""

    source: Union[ArrivalLog, Callable[[], ArrivalLog]]
    chunks_per_server: int = 4             # canonical row budget / server
    kind: str = "trace"

    def merge(self, other):
        """Rightmost non-uniform wins — same contract as PlacementSpec."""
        return other if getattr(other, "kind", "uniform") != "uniform" \
            else self

    def budget(self, M: int) -> int:
        """Catalog-row budget for an M-server cluster."""
        return self.chunks_per_server * M

    @property
    def n_epochs(self) -> int:
        """Churn-epoch count (canonical-pad sizing; see registry_limits)."""
        return _resolve(self.source).n_epochs

    def realize_epochs(self, T: int) -> np.ndarray:
        """[T] int32 slot -> churn-epoch index (by slot midpoint)."""
        bounds = np.asarray(_resolve(self.source).churn_t, np.float64)
        frac = (np.arange(T) + 0.5) / T
        return np.searchsorted(bounds, frac, side="right").astype(np.int32)

    def realize_catalog(self, cluster, rng: np.random.Generator):
        """(logits [C], locals [C, n_rep], epoch_logits [E, C]).

        ``logits`` is the whole-trace popularity mass over the epoch-major
        catalog rows; ``epoch_logits[e]`` is the CONDITIONAL popularity
        while epoch e is active — mass only on epoch e's rows, normalized
        within the epoch — so the simulator reproduces the trace's
        per-instant skew instead of a mixture diluted across episodes.
        Replica triples are drawn from the realize() rng (distinct
        servers, uniform placement — trace logs address chunks, not
        servers, so server assignment is the scenario seed's)."""
        log = _resolve(self.source)
        plans = catalog_plan(log, self.budget(cluster.M))
        mass = np.concatenate([p.mass for p in plans])
        logits = np.log(np.maximum(mass, _TINY)
                        / max(log.n_tasks, 1)).astype(np.float32)
        C = mass.shape[0]
        epoch_logits = np.full((len(plans), C), np.log(_TINY), np.float32)
        for e, plan in enumerate(plans):
            rows = slice(plan.row0, plan.row0 + plan.mass.shape[0])
            epoch_logits[e, rows] = np.log(
                np.maximum(plan.mass, _TINY) / max(plan.mass.sum(), 1.0))
        order = np.argsort(rng.random((C, cluster.M)), axis=1)
        locals_ = order[:, :cluster.n_replicas].astype(np.int32)
        return logits, locals_, epoch_logits


def fit_size_sigma(log: ArrivalLog) -> float:
    """Log-space std of the observed size multipliers (0 when constant)."""
    return float(np.std(np.log(np.asarray(log.size, np.float64))))


def scenario_from_trace(source, *, name: Optional[str] = None,
                        chunks_per_server: int = 4,
                        seed: int = 0) -> Scenario:
    """Lower a trace (ArrivalLog or lazy thunk) into a Scenario."""
    log = _resolve(source)
    return Scenario(
        name=name or f"trace:{log.name}",
        traffic=TraceTraffic(source=source),
        placement=TracePlacement(source=source,
                                 chunks_per_server=chunks_per_server),
        sizes=SizeSpec(sigma=fit_size_sigma(log)),
        seed=seed,
        description=f"trace-lowered scenario from arrival log "
                    f"{log.name!r} ({log.n_tasks} tasks, "
                    f"{log.n_epochs} placement epochs)")
