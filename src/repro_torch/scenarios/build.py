"""Realize a Scenario spec into the tensors the simulator's slot loop reads.

PyTorch mirror of ``repro.scenarios.build``.  ``realize(scenario, cluster,
rates, T, pad=None, *, device=None)`` turns a declarative
:class:`~repro_torch.scenarios.spec.Scenario` into a :class:`ScenarioData`
of tensors on ``device`` plus the scenario's capacity-region edge
``lam_cap`` (tasks/slot at load 1).  Realization runs on the host in numpy,
as in the reference, so the same ``scenario.seed`` gives the same arrays bit
for bit; only the finished arrays move to the device.

Two functions run in the slot loop and read no device value on the host:
``speed_at`` (the slot's [M, 3] per-class speed, from the window stack) and
``sample_locals_scenario`` (replica triples under the placement law, the
slot's churn epoch choosing the popularity row).

``pad`` (:class:`ScenarioPad`, usually :func:`canonical_pad`) pads the
window, catalog and epoch arrays to registry-wide maxima and selects the
placement law by data (``placement_on``), so every scenario shares one set
of shapes; ``canonical_a_max`` gives one arrival-buffer width for a sweep.
``stack_scenarios`` realizes a list of scenarios against one pad and stacks
them on a leading [S] axis: the grid sweep's input.  ``speed_at`` and
``placement_epoch_at`` read a stacked ScenarioData too, for all S
scenarios in the launches one takes.

All float arrays are float32 (except host-side capacity integration,
float64); index arrays are int32.
"""
from __future__ import annotations

import math
from typing import TYPE_CHECKING, NamedTuple, Optional

import numpy as np
import torch

from .spec import (
    COMPOSE_DEPTH,
    SCENARIOS,
    FleetSpec,
    PlacementSpec,
    Scenario,
    TrafficSpec,
    WindowSpec,
    get_scenario,
    registry_limits,
)

if TYPE_CHECKING:  # runtime import would cycle: core.simulator imports us
    from ..core.cluster import Cluster, Rates


class ScenarioData(NamedTuple):
    """Realized scenario tensors, fields and order as the reference's.

    lam_shape     [T]  arrival-intensity shape, mean ~1 (multiplies lambda)
    base_speed    [M]  persistent per-server speed multipliers
    win_start/end [E]  event-window slot bounds (E may be 0)
    win_mult      [E, M, 3] per-window, per-locality-class speed multiplier
                  (1.0 = unaffected)
    chunk_logits  [C]  log chunk popularity, or None for uniform placement
    chunk_locals  [C, n_replicas] each chunk's replica triple, or None
    placement_on  scalar 0/1: padded realizations choose the placement law
                  by data (1 -> the chunk catalog, 0 -> uniform), or None
    size_mu       scalar log-mean of the per-task size multiplier
                  (-sigma^2/2, so the multiplier has mean 1)
    size_sigma    scalar log-std; 0.0 leaves durations untouched bit for bit
    epoch_logits  [P, C] per-churn-epoch chunk popularity, or None
    placement_epoch  [T] int32 slot -> churn-epoch index, or None
    """

    lam_shape: torch.Tensor
    base_speed: torch.Tensor
    win_start: torch.Tensor
    win_end: torch.Tensor
    win_mult: torch.Tensor
    chunk_logits: Optional[torch.Tensor]
    chunk_locals: Optional[torch.Tensor]
    placement_on: Optional[torch.Tensor] = None
    size_mu: Optional[torch.Tensor] = None
    size_sigma: Optional[torch.Tensor] = None
    epoch_logits: Optional[torch.Tensor] = None
    placement_epoch: Optional[torch.Tensor] = None

    @property
    def M(self) -> int:
        """Number of servers this realization was built for."""
        return self.base_speed.shape[-1]


class ScenarioPad(NamedTuple):
    """Canonical array shapes every realized scenario is padded to.

    n_windows: event-window slots (inactive pads: start == end == 0,
    mult == 1).  n_chunks: placement-catalog rows (pads get ~ -inf logits,
    so they are never drawn).  n_epochs: churn-epoch popularity rows."""

    n_windows: int
    n_chunks: int
    n_epochs: int = 1


def host(a, dtype=None) -> np.ndarray:
    """A numpy copy of a tensor on any device, or ``np.asarray`` of
    anything else (the reference's arrays, numpy leaves)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def canonical_pad(cluster: "Cluster", scenarios=None,
                  compose_depth: Optional[int] = None) -> ScenarioPad:
    """The registry-wide ScenarioPad (or for an explicit scenario subset);
    ``compose_depth`` widens the window budget for deeper ``compose()``
    products (default: spec.COMPOSE_DEPTH = 2)."""
    n_windows, chunks_per_server, n_epochs = registry_limits(
        scenarios, compose_depth=compose_depth)
    return ScenarioPad(n_windows=max(n_windows, 1),
                       n_chunks=max(chunks_per_server * cluster.M, 1),
                       n_epochs=max(n_epochs, 1))


def canonical_a_max(cluster: "Cluster", rates: "Rates", cfg, load: float,
                    scenarios=None) -> int:
    """One arrival-batch width valid for every scenario in the sweep, sized
    from each scenario's PEAK slot intensity; ``cfg`` is any object with
    ``T`` and ``resolve_a_max(lam, shape_peak)`` (a ``core.SimConfig``).
    Realizes on the host only."""
    specs = tuple(scenarios) if scenarios is not None else tuple(
        SCENARIOS.values())
    a_max = 1
    for s in specs:
        scen, lam_cap = _realize_host(get_scenario(s), cluster, rates, cfg.T)
        shape_peak = float(np.max(scen.lam_shape))
        a_max = max(a_max, cfg.resolve_a_max(float(load) * lam_cap,
                                             shape_peak))
    return a_max


def speed_at(scen: ScenarioData, t) -> torch.Tensor:
    """[M, 3] effective per-class speed at slot ``t`` (a Python int or a
    0-d tensor: nothing is read on the host); [S, M, 3] for a stacked
    ScenarioData (``stack_scenarios``), in as many launches.  Column c
    scales the class-c service rate; overlapping windows compose
    multiplicatively.

    The windows fold left to right, ((m_0 * m_1) * m_2) ..., then the base
    speed multiplies: the order in which the reference's product reduces
    on XLA's CPU backend, so the speeds are equal to the bit (with three or
    more non-unit factors on a server the order decides the last bit)."""
    base = scen.base_speed[..., None]                            # [.., M, 1]
    if scen.win_start.shape[-1] == 0:
        return base.expand(*base.shape[:-1], 3)                  # a view
    active = (scen.win_start <= t) & (t < scen.win_end)          # [.., E]
    mult = torch.where(active[..., None, None], scen.win_mult, 1.0)
    prod = mult[..., 0, :, :]                                    # [.., M, 3]
    for e in range(1, mult.shape[-3]):
        prod = prod * mult[..., e, :, :]
    return base * prod


def speed_trace(scen: ScenarioData, T: int) -> np.ndarray:
    """[T, M, 3] host-side speed trace (tests / plots; not the hot path)."""
    start = host(scen.win_start)[None, :]                        # [1, E]
    end = host(scen.win_end)[None, :]
    t = np.arange(T)[:, None]                                    # [T, 1]
    active = (start <= t) & (t < end)                            # [T, E]
    mult = np.where(active[:, :, None, None],
                    host(scen.win_mult)[None], 1.0)              # [T, E, M, 3]
    return host(scen.base_speed)[None, :, None] * mult.prod(axis=1)


# ---------------------------------------------------------------------------
# Fleet axis
# ---------------------------------------------------------------------------


def _check_rack(r: int, cluster: "Cluster", w: WindowSpec) -> None:
    # loud, not silent: an out-of-range rack would otherwise realize as an
    # all-False mask, a failure event that never happens
    if not 0 <= r < cluster.K:
        raise ValueError(f"window {w} targets rack {r}, but the cluster "
                         f"has K={cluster.K} racks")


def _window_mask(w: WindowSpec, cluster: "Cluster") -> np.ndarray:
    m = np.arange(cluster.M)
    if w.rack is not None:
        _check_rack(w.rack, cluster, w)
        return (m // cluster.rack_size) == w.rack
    if w.servers is not None:
        lo, hi = w.servers
        return (m >= lo) & (m < hi)
    if w.every is not None:
        return (m % w.every) == w.phase
    if w.rack_member is not None:
        r, i = w.rack_member
        _check_rack(r, cluster, w)
        return m == r * cluster.rack_size + (i % cluster.rack_size)
    raise ValueError(f"window {w} selects no servers")


def _fleet_arrays(fleet: FleetSpec, cluster: "Cluster", T: int,
                  rng: np.random.Generator):
    M = cluster.M
    base = np.ones(M, np.float32)
    for r, s in enumerate(fleet.rack_speeds):
        base[r * cluster.rack_size:(r + 1) * cluster.rack_size] = s
    for frac, s_mult in fleet.cohorts():
        k = max(1, int(round(frac * M)))
        base[rng.choice(M, size=k, replace=False)] *= s_mult
    E = len(fleet.windows)
    start = np.zeros(E, np.int32)
    end = np.zeros(E, np.int32)
    mult = np.ones((E, M, 3), np.float32)
    for e, w in enumerate(fleet.windows):
        start[e] = int(round(w.t0 * T))
        end[e] = int(round(w.t1 * T))
        mult[e, _window_mask(w, cluster)] = np.asarray(w.class_mult,
                                                      np.float32)
    return base, start, end, mult


def capacity_scale(scen: ScenarioData, T: int) -> float:
    """Time-averaged sum_m local_speed_t[m] / M: the heterogeneous capacity
    region edge relative to the symmetric M * alpha (only the LOCAL column
    of the window multipliers matters).  Exact: windows make speed
    piecewise constant, so integrate over the boundary segments."""
    start = host(scen.win_start)
    end = host(scen.win_end)
    bounds = np.unique(np.clip(np.concatenate(
        [[0, T], start, end]), 0, T)).astype(np.int64)
    total = 0.0
    base = host(scen.base_speed, np.float64)
    mult = host(scen.win_mult, np.float64)[:, :, 0]          # local tier
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        active = (start <= lo) & (lo < end)                      # [E]
        seg = base * np.where(active[:, None], mult, 1.0).prod(axis=0)
        total += float(seg.sum()) * (hi - lo)
    return total / (T * scen.M)


# ---------------------------------------------------------------------------
# Traffic axis
# ---------------------------------------------------------------------------


def _shape_one(spec: TrafficSpec, T: int,
               rng: np.random.Generator) -> np.ndarray:
    """[T] float64 raw intensity shape of a single factor, clamped >= 0."""
    if hasattr(spec, "realize_shape"):
        # duck-typed extension hook: trace-backed traffic bins recorded
        # arrival timestamps instead of evaluating a formula
        return np.maximum(
            np.asarray(spec.realize_shape(T, rng), np.float64), 0.0)
    t = np.arange(T, dtype=np.float64)
    if spec.kind == "stationary":
        shape = np.ones(T)
    elif spec.kind == "diurnal":
        shape = 1.0 + spec.amp * np.sin(2.0 * math.pi * spec.cycles * t / T)
    elif spec.kind == "flash":
        shape = np.ones(T)
        shape[int(spec.t0 * T):int(spec.t1 * T)] = spec.peak
    elif spec.kind == "mmpp":
        # 2-state Markov chain simulated host-side, started from the
        # stationary distribution so warmup statistics are unbiased
        p01, p10 = spec.p_enter, spec.p_exit
        pi_burst = p01 / max(p01 + p10, 1e-12)
        state = 1 if rng.random() < pi_burst else 0
        shape = np.empty(T)
        u = rng.random(T)
        for i in range(T):
            shape[i] = spec.burst if state else 1.0
            if state == 0 and u[i] < p01:
                state = 1
            elif state == 1 and u[i] < p10:
                state = 0
    else:
        raise ValueError(f"unknown traffic kind {spec.kind!r}")
    # clamp before multiplying/normalizing: amp > 1 diurnals would otherwise
    # produce negative intensities instead of dead zones
    return np.maximum(shape, 0.0)


def traffic_shape(spec, T: int, rng: np.random.Generator) -> np.ndarray:
    """[T] float32 intensity shape, normalized to mean 1 over the run: the
    factors of a TrafficSpec or TrafficProduct realized left to right
    against the shared rng, multiplied pointwise, normalized once."""
    shape = np.ones(T, np.float64)
    for part in (spec.parts or (spec,)):
        shape = shape * _shape_one(part, T, rng)
    shape = shape / max(shape.mean(), 1e-12)
    return shape.astype(np.float32)


def arrival_counts(spec, T: int, mean_per_tick: float,
                   seed: int = 0) -> np.ndarray:
    """[T] int64 Poisson arrival counts following the traffic shape (the
    arrival trace the serving engine replays)."""
    rng = np.random.default_rng(seed)
    return rng.poisson(mean_per_tick * traffic_shape(spec, T, rng))


# ---------------------------------------------------------------------------
# Placement axis
# ---------------------------------------------------------------------------


def _placement_arrays(spec: PlacementSpec, cluster: "Cluster",
                      rng: np.random.Generator):
    """(chunk_logits [C], chunk_locals [C, n_rep], epoch_logits [P, C]) as
    numpy; the last is None for single-epoch placements, all three for
    uniform placement."""
    if hasattr(spec, "realize_catalog"):
        # duck-typed extension hook: trace-backed placement derives the
        # catalog from observed chunk ids and churn episodes
        logits, locals_, epoch_logits = spec.realize_catalog(cluster, rng)
        return (np.asarray(logits), np.asarray(locals_),
                None if epoch_logits is None else np.asarray(epoch_logits))
    if spec.kind == "uniform":
        return None, None, None
    if spec.kind != "zipf":
        raise ValueError(f"unknown placement kind {spec.kind!r}")
    C = spec.chunks_per_server * cluster.M
    popularity = np.arange(1, C + 1, dtype=np.float64) ** (-spec.zipf_s)
    logits = np.log(popularity / popularity.sum()).astype(np.float32)
    # each chunk's replica triple: distinct servers, uniform placement (the
    # popularity is skewed, not the placement itself)
    order = np.argsort(rng.random((C, cluster.M)), axis=1)
    locals_ = order[:, :cluster.n_replicas].astype(np.int32)
    if spec.hot_rack is not None:
        # adversarial placement: the hot head of the catalog lives entirely
        # inside one rack
        R = cluster.rack_size
        if not 0 <= spec.hot_rack < cluster.K:
            raise ValueError(f"hot_rack {spec.hot_rack} out of range for "
                             f"K={cluster.K} racks")
        if R < cluster.n_replicas:
            raise ValueError(f"rack_size {R} cannot host "
                             f"{cluster.n_replicas} distinct replicas")
        n_hot = max(1, min(C, math.ceil(spec.hot_frac * C)))
        members = spec.hot_rack * R + np.arange(R)
        horder = np.argsort(rng.random((n_hot, R)), axis=1)
        locals_[:n_hot] = members[
            horder[:, :cluster.n_replicas]].astype(np.int32)
    return logits, locals_, None


def placement_epoch_at(scen: Optional[ScenarioData], t):
    """Churn-epoch index at slot ``t`` (a 0-d tensor, [S] for a stacked
    ScenarioData, or 0 when the scenario has no time-varying placement)."""
    if scen is None or scen.placement_epoch is None:
        return 0
    return scen.placement_epoch[..., t]


def placement_cdf(scen: ScenarioData) -> Optional[torch.Tensor]:
    """[P, C] float64 cumulative chunk law of each churn epoch (one row,
    the global law, without epochs), each row ending at exactly 1.0, on
    the scenario's device; None for uniform placement.  Pad chunks (~ -inf
    logits) add nothing, so they are never drawn.  Summed on the host in
    one order, so every device draws against the same table (read once a
    run)."""
    if scen.chunk_locals is None:
        return None
    logits = host(scen.epoch_logits if scen.epoch_logits is not None
                  else scen.chunk_logits[None, :], np.float64)
    p = np.exp(logits - logits.max(axis=-1, keepdims=True))
    cdf = np.cumsum(p, axis=-1)
    return torch.tensor(cdf / cdf[:, -1:], device=scen.base_speed.device)


def sample_locals_scenario(gen: torch.Generator, cluster: "Cluster",
                           scen: ScenarioData, batch, pe=0,
                           cdf: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Replica triples for ``batch`` tasks (an int or a shape) under the
    scenario's placement, int32 [*batch, n_rep], on the scenario's device.

    Uniform placement defers to ``core.cluster.sample_locals`` (the same
    draws).  A chunk catalog draws each task's chunk from the popularity
    law by inversion (a float64 uniform searched in ``placement_cdf``) and
    returns its triple; ``pe``, an int or an int tensor over the leading
    dimensions of ``batch``, selects the churn epoch's row.  Padded
    realizations carry ``placement_on`` and select between the two laws by
    data: both are drawn and a device-side where picks one.  ``cdf`` may
    pass ``placement_cdf(scen)`` precomputed."""
    from ..core.cluster import sample_locals

    shape = (batch,) if isinstance(batch, int) else tuple(batch)
    dev = scen.base_speed.device
    uniform = lambda: sample_locals(gen, cluster, math.prod(shape),
                                    dev).view(*shape, -1)
    if scen.chunk_locals is None:
        return uniform()
    if cdf is None:
        cdf = placement_cdf(scen)
    u = torch.rand(shape, generator=gen, dtype=torch.float64, device=dev)
    rows = cdf[0] if cdf.shape[0] == 1 else cdf[torch.as_tensor(
        pe, device=dev).to(torch.int64)]
    idx = torch.searchsorted(rows, u, right=True)
    skewed = scen.chunk_locals[idx]
    if scen.placement_on is None:
        return skewed
    return torch.where(scen.placement_on > 0, skewed, uniform())


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------


_PAD_LOGIT = -1e30  # effectively -inf popularity: pad chunks are never drawn


def _pad_placement(chunk_logits, chunk_locals, epoch_logits,
                   cluster: "Cluster", n_chunks: int, n_epochs: int):
    """Canonicalize the placement axis to ``n_chunks`` catalog rows and
    ``n_epochs`` churn-epoch rows (numpy).  Uniform scenarios get a dummy
    catalog (never drawn: placement_on = 0); skewed ones are padded with
    _PAD_LOGIT rows whose triples are the first n_replicas server ids.
    Single-epoch placements mirror the global law in epoch row 0."""
    n_rep = cluster.n_replicas
    dummy_row = np.arange(n_rep, dtype=np.int32)[None, :]
    if chunk_logits is None:
        logits = np.full(n_chunks, _PAD_LOGIT, np.float32)
        locals_ = np.repeat(dummy_row, n_chunks, axis=0)
        on = 0.0
    else:
        logits = np.asarray(chunk_logits, np.float32)
        locals_ = np.asarray(chunk_locals, np.int32)
        C = logits.shape[0]
        assert C <= n_chunks, (C, n_chunks)
        logits = np.pad(logits, (0, n_chunks - C),
                        constant_values=_PAD_LOGIT)
        locals_ = np.concatenate(
            [locals_, np.repeat(dummy_row, n_chunks - C, axis=0)], axis=0)
        on = 1.0
    if epoch_logits is None:
        elog = np.full((n_epochs, n_chunks), _PAD_LOGIT, np.float32)
        elog[0] = logits
    else:
        elog = np.asarray(epoch_logits, np.float32)
        E, C = elog.shape
        assert E <= n_epochs and C <= n_chunks, (elog.shape, n_epochs,
                                                 n_chunks)
        elog = np.pad(elog, ((0, n_epochs - E), (0, n_chunks - C)),
                      constant_values=_PAD_LOGIT)
    return logits, locals_, np.float32(on), elog


def _realize_host(scenario: Scenario, cluster: "Cluster", rates: "Rates",
                  T: int, pad: Optional[ScenarioPad] = None
                  ) -> tuple[ScenarioData, float]:
    """``realize`` with numpy leaves, on the host."""
    rng = np.random.default_rng(scenario.seed)
    base, wstart, wend, wmult = _fleet_arrays(scenario.fleet, cluster, T, rng)
    lam_shape = traffic_shape(scenario.traffic, T, rng)
    chunk_logits, chunk_locals, epoch_logits = _placement_arrays(
        scenario.placement, cluster, rng)
    placement_epoch = (
        np.asarray(scenario.placement.realize_epochs(T), np.int32)
        if hasattr(scenario.placement, "realize_epochs") else None)
    # per-task size law: lognormal normalized to mean exactly 1
    # (mu = -sigma^2/2), so lam_cap needs no size correction
    sigma = float(scenario.sizes.sigma)
    placement_on = None
    if pad is not None:
        E = wstart.shape[0]
        if E > pad.n_windows:
            raise ValueError(
                f"scenario {scenario.name!r} has {E} event windows but the "
                f"pad reserves only {pad.n_windows} (the default budget "
                f"covers {COMPOSE_DEPTH}-way compose() products).  Widen "
                f"it explicitly: canonical_pad(cluster, "
                f"compose_depth={max(2, -(-E // max(pad.n_windows // COMPOSE_DEPTH, 1)))}) "
                f"— or pad._replace(n_windows={E}) for a one-off")
        wstart = np.pad(wstart, (0, pad.n_windows - E))
        wend = np.pad(wend, (0, pad.n_windows - E))      # start == end: inert
        wmult = np.pad(wmult, ((0, pad.n_windows - E), (0, 0), (0, 0)),
                       constant_values=1.0)
        chunk_logits, chunk_locals, placement_on, epoch_logits = \
            _pad_placement(chunk_logits, chunk_locals, epoch_logits,
                           cluster, pad.n_chunks, pad.n_epochs)
        if placement_epoch is None:
            placement_epoch = np.zeros(T, np.int32)
    scen = ScenarioData(
        lam_shape=lam_shape, base_speed=base, win_start=wstart, win_end=wend,
        win_mult=wmult, chunk_logits=chunk_logits, chunk_locals=chunk_locals,
        placement_on=placement_on, size_mu=np.float32(-0.5 * sigma * sigma),
        size_sigma=np.float32(sigma), epoch_logits=epoch_logits,
        placement_epoch=placement_epoch)
    # placement-aware capacity edge: uniform placement keeps the closed
    # form, skewed catalogs get the fluid-LP optimum (local import:
    # capacity.py imports from this module)
    from .capacity import capacity_edge
    return scen, capacity_edge(scen, cluster, rates, T)


def scenario_from_numpy(scen, device="cpu") -> ScenarioData:
    """A ScenarioData of tensors on ``device`` from any object with the
    same fields holding arrays (numpy, or the reference's realization):
    float arrays as float32, index arrays as int32, None kept."""
    def tensor(name, a):
        if a is None:
            return None
        a = host(a)
        dtype = torch.int32 if name in ("win_start", "win_end", "chunk_locals",
                                        "placement_epoch") else torch.float32
        return torch.tensor(a, dtype=dtype, device=device)
    return ScenarioData(*(tensor(n, getattr(scen, n))
                          for n in ScenarioData._fields))


def scenario_row(stacked: ScenarioData, s: int) -> ScenarioData:
    """Scenario ``s`` of a stacked ScenarioData, its leaves views."""
    return ScenarioData(*(None if x is None else x[s] for x in stacked))


def stack_scenarios(scenarios, cluster: "Cluster", rates: "Rates", T: int,
                    pad: Optional[ScenarioPad] = None, *, device=None):
    """Realize every scenario against ONE pad and stack the realizations
    along a new leading axis.

    Returns ``(stacked, lam_caps)``: a ScenarioData whose every leaf
    carries a leading [S] scenario axis, on ``device``, and a float64 [S]
    numpy array of capacity-region edges (tasks/slot at load 1) in the same
    order.  ``scenarios`` is an iterable of registered names and/or
    Scenario objects; ``pad`` defaults to the registry-wide
    ``canonical_pad``.  Raises on an empty list, and when a realization
    escapes the shared shapes (e.g. an ad-hoc composition exceeding the
    pad's window headroom).  device: None stacks onto the CUDA card (and
    raises without one); pass "cpu" for the CPU.  Realization runs on the
    host, and the stack moves to the device once."""
    from ..core.simulator import resolve_device

    dev = resolve_device(device)
    if pad is None:
        pad = canonical_pad(cluster)
    specs = list(scenarios)
    scens, caps = [], []
    for spec in specs:
        scen, cap = _realize_host(get_scenario(spec), cluster, rates, T, pad)
        scens.append(scen)
        caps.append(cap)
    if not scens:
        raise ValueError("stack_scenarios: empty scenario list")
    sig = lambda sc: [None if x is None else np.shape(x) for x in sc]
    for spec, scen in zip(specs[1:], scens[1:]):
        if sig(scen) != sig(scens[0]):
            raise ValueError(
                f"stack_scenarios: scenario {getattr(spec, 'name', spec)!r} "
                f"does not realize to the shared canonical signature {pad} — "
                "widen the pad, e.g. canonical_pad(cluster, "
                "compose_depth=3) for 3-way compose() products "
                "(see registry_limits)")
    stacked = ScenarioData(*(None if xs[0] is None else np.stack(xs)
                             for xs in zip(*scens)))
    return scenario_from_numpy(stacked, dev), np.asarray(caps, np.float64)


def realize(scenario, cluster: "Cluster", rates: "Rates", T: int,
            pad: Optional[ScenarioPad] = None, *, device=None
            ) -> tuple[ScenarioData, float]:
    """``(ScenarioData, lam_cap)`` for ``scenario`` (a Scenario, a
    registered name, or None for ``uniform``): the tensors on ``device``
    and the capacity-region edge in tasks per slot at load 1.
    Deterministic in ``scenario.seed``; equal to the reference's
    realization.  ``pad`` canonicalizes the shapes (see module docstring);
    pad=None gives the unpadded realization.  device: None realizes onto
    the CUDA card (and raises without one); pass "cpu" for the CPU."""
    from ..core.simulator import resolve_device

    dev = resolve_device(device)
    scen, lam_cap = _realize_host(get_scenario(scenario), cluster, rates, T,
                                  pad)
    return scenario_from_numpy(scen, dev), lam_cap
