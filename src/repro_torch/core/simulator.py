"""Discrete-time slotted simulator (paper §III-IV).

PyTorch mirror of ``repro.core.simulator``.  Three queue-structure families
cover the paper's six algorithms:

  BP family      (3 sub-queues per server: local / rack-local / remote)
      balanced_pandas            routing: argmin weighted workload over all M
      balanced_pandas_pod        routing: argmin over the 3 locals + d samples
      balanced_pandas_randomtie  balanced_pandas with random (not
                                 class-first) ties on the sequential path
      scheduling (all): an idle server serves its own local queue, then
      rack-local, then remote.
  SQ family      (one queue per server; queued tasks are local to it)
      jsq_maxweight        routing: shortest local queue; scheduling: argmax
                           over all M of {alpha*Q_own, beta*Q_rack,
                           gamma*Q_other}
      jsq_maxweight_pod    scheduling: argmax over own + d' sampled queues
      jsq_priority         scheduling: own queue, else the longest in the
                           rack, else the longest anywhere
  FCFS           (one central queue; idle servers grab the head task)

Within a slot the order is completions -> scheduling -> arrivals, and the
task count N is read at slot end, so Little's law gives the mean completion
time.  Scheduling is batched per slot: up to ``SimConfig.s_max`` idle
servers act against one snapshot, steal conflicts resolved by weight
priority and queue lengths.  The slot loop (``_slot_loop``) is one
Python loop over the run's draw blocks, on every device and for every
family: it fills a block, then runs the block's slots; in the batched
route mode (the main path) nothing in it reads a device value on the
host, so the card runs ahead of the loop.  A slot runs in one of two
ways.  On a CUDA device the BP family's batched loop (no size law, no
telemetry, the default draws, at least one draw block) replays the slot
step as CUDA graphs of 8 slots (``_SlotGraphs``, ``_captures``),
captured once a set of shapes, on the homogeneous path and off it (a
scenario's speeds are then computed inside the graph); every other slot
steps eagerly.  Both get the same operands and the same slot views.

Routing modes:
  batched    — the slot's arrival batch routes through ONE launch of the
               ``route_commit`` kernel (kernels/route_commit.py): each
               arrival scores against the workloads left by the previous
               one's commit; exact ties break by locality class, then a
               per-slot random priority (full BP) or candidate slot (pod).
               The SQ family rides the pod kernel with unit rates (queue
               length == workload), its replica triple as the candidates:
               ties then break by replica slot.
  sequential — plain per-arrival PyTorch routing with random tie-breaks,
               the paper's model, what the batched path is checked against.
               It reads each slot's arrival count on the host.

Random draws.  torch's generators cannot reproduce JAX's threefry stream,
so a slot takes all of its random numbers through one seam: ``SlotDraws``
(BP), ``SQDraws`` or ``FCFSDraws``.  The default source (``TorchDraws``)
fills it from a ``torch.Generator``; a test fills it from the JAX key
derivation instead and then holds the port's slot step to the reference's,
bit for bit.

Scenarios (``repro_torch.scenarios``): a slot reads its [M, 3] per-class
speed from ``speed_at``.  A busy server completes ``speed[m, cls]`` work
units a slot; a tier at speed 0 starts nothing of that class, and a server
with every tier at 0 schedules nothing; BP's workload and routing divide by
the slot's own [M, 3] rates, ``+inf`` where a tier is down.  A realization
with unit speeds and no windows (``uniform``) takes the homogeneous fast
path instead: unit speeds, no masks, the ``[3]`` rate vector.  Skewed
placement and the per-task size law enter through the draws.

Telemetry (``repro_torch.telemetry``): with a ``TelemetryConfig`` the slot
steps also feed the collectors (windows, histograms, sojourn rings, probe
rank and regret), which update their tensors in place, take no draw and
read nothing on the host, so the sums are those of the run without them.
Batched BP ranks each decision against the workloads the kernel scored it
with (``kernels.ref.route_commit_wseq``).

Cells.  Every state tensor, accumulator and draw carries a leading cell
axis [N], and one slot step advances all N cells at once: the BP and SQ
families route every cell's arrival batch through ONE ``route_commit``
launch (one CTA a cell).  ``simulate`` runs a grid of one cell;
``simulate_grid`` runs loads x seeds of one scenario and ``simulate_sweep``
scenarios x seeds x loads (``sweep_grid``, ``scenarios.stack_scenarios``),
each in one slot loop.  Seed k of every cell draws from its own
``torch.Generator`` seeded ``seed0 + k``, the generator a looped
``simulate(..., key=seed0 + k)`` uses, so a cell equals that looped run bit
for bit when both share the grid's ``a_max``.  The slot steps also take one
cell's unbatched state (the level-2 parity tests feed them so).

Tracing.  Under a recording ``torch.profiler`` the entry points and the
slot loop record the host spans of ``repro_torch.spans``: the grid's fixed
cost a call (``sim.grid.*``), the draws (``sim.draws``: a slot's where
the whole loop steps eagerly, a block's fill where it replays CUDA graphs;
the cells' ``sim.draws.fill``, the block's ``sim.draws.stack`` and an
eager slot's ``sim.draws.class_grid`` for full BP inside it, except in a
replayed block's eager tail) and the phases of every eager step
(``sim.step.*``, ``sim.scenario.speed``), the same names in every family.
A replayed slot records no span, its speeds and class grid none either.
Without a profiler a span site costs one check.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..kernels.invrates import LAUNCHES, MATRIX_LAUNCHES, reset_launch_counts
from ..kernels.ref import route_commit_wseq, workload
from ..kernels.route_commit import route_commit
from ..telemetry import collectors as tlm
from ..telemetry.export import WarmupPolicy, auto_extend_warmup
from ..scenarios.build import (ScenarioData, host, placement_cdf, realize,
                               sample_locals_scenario, scenario_row,
                               speed_at, stack_scenarios)
from ..scenarios.spec import scenario_names
from ..spans import span
from .cluster import (GEOMETRIC, LOCAL, LOGNORMAL, RACK, REMOTE, Cluster,
                      Rates, durations_from_normal, durations_from_uniform,
                      locality_class, safe_inv_rates, sample_locals,
                      uniform_int, uniform_open)
from .policies import (PodSpec, bp_candidates_per_route, inv_rate_for,
                       jsqmw_candidates_per_schedule, lex_argmax,
                       pod_candidate_classes, pod_candidates, rack_peer_of,
                       remote_peer_of, route_balanced_pandas_full,
                       route_jsq_local, route_pod_candidates, take_last,
                       weighted_score)

_F = torch.float32
_INF = float("inf")


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no card and no explicit request this raises; it never
    falls back to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: pass device='cpu' to run "
                               "the port on the CPU")
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {dev} requested but CUDA is unavailable")
    return dev


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Static simulation parameters."""

    T: int = 20_000               # total slots
    warmup: int = 4_000           # slots discarded before measuring
    a_max: int = 0                # max arrivals per slot (0 = auto from load)
    s_max: int = 64               # max scheduling attempts per slot
    route_mode: str = "sequential"  # "sequential" | "batched"
    service_dist: str = GEOMETRIC   # "geometric" | "lognormal"
    sigma: float = 1.0              # log-normal shape

    def resolve_a_max(self, lam: float, shape_peak: float = 1.0) -> int:
        """Arrival-buffer width from the peak slot intensity:
        peak + 6*sqrt(peak) + 4 (P(clip) per slot ~1e-9)."""
        if self.a_max > 0:
            return self.a_max
        peak = lam * shape_peak
        return int(math.ceil(peak + 6.0 * math.sqrt(peak) + 4))


class RawSums(NamedTuple):
    """Per-run float32 accumulators."""

    slots: torch.Tensor
    sum_N: torch.Tensor
    sum_N_h1: torch.Tensor
    sum_N_h2: torch.Tensor
    arrivals: torch.Tensor
    clipped: torch.Tensor
    completions: torch.Tensor
    starts: torch.Tensor        # [3] service starts by locality class
    routed: torch.Tensor        # [3] routing decisions by chosen class
    busy: torch.Tensor
    route_decisions: torch.Tensor
    sched_decisions: torch.Tensor
    final_N: torch.Tensor

    @staticmethod
    def zero(device="cpu", cells: Optional[int] = None) -> "RawSums":
        """All-zero accumulator, with a leading [cells] axis if given."""
        lead = () if cells is None else (cells,)
        z = lambda *s: torch.zeros(lead + s, dtype=_F, device=device)
        return RawSums(z(), z(), z(), z(), z(), z(), z(), z(3), z(3), z(),
                       z(), z(), z())


class SimResult(NamedTuple):
    """Per-run summary statistics (``summarize``)."""

    mean_tasks_in_system: torch.Tensor
    mean_completion_slots: torch.Tensor
    mean_completion_norm: torch.Tensor   # units of mean local service time
    arrival_rate_hat: torch.Tensor
    throughput: torch.Tensor
    utilization: torch.Tensor
    locality_fractions: torch.Tensor     # [3] of service starts
    routed_fractions: torch.Tensor       # [3] of routing choices
    drift: torch.Tensor                  # mean_N(2nd half) / mean_N(1st half);
    #                                      NaN when the 1st half saw no mass
    clip_fraction: torch.Tensor
    route_decisions: torch.Tensor
    sched_decisions: torch.Tensor
    route_candidates_per_decision: torch.Tensor
    sched_candidates_per_decision: torch.Tensor


class BPState(NamedTuple):
    """Balanced-Pandas family state: per-server 3-class sub-queues."""

    Q: torch.Tensor          # int32 [M, 3] sub-queue lengths
    busy: torch.Tensor       # bool  [M]
    rem: torch.Tensor        # f32   [M] remaining service work units
    cls: torch.Tensor        # int32 [M] class of the in-service task

    @staticmethod
    def zero(M: int, device="cpu", cells: Optional[int] = None) -> "BPState":
        """Empty cluster of M servers (in each of ``cells`` cells)."""
        return BPState(torch.zeros(_lead(cells) + (M, 3), dtype=torch.int32,
                                   device=device),
                       *_idle_servers(M, device, cells))


def _lead(cells: Optional[int]) -> tuple:
    return () if cells is None else (cells,)


def _idle_servers(M: int, device, cells: Optional[int] = None):
    """(busy, rem, cls) of M idle servers, the last three fields of every
    family's state."""
    shape = _lead(cells) + (M,)
    return (torch.zeros(shape, dtype=torch.bool, device=device),
            torch.zeros(shape, dtype=_F, device=device),
            torch.zeros(shape, dtype=torch.int32, device=device))


class SQState(NamedTuple):
    """SQ family state: one queue per server."""

    Q: torch.Tensor          # int32 [M] queue lengths (tasks local to server)
    busy: torch.Tensor       # bool  [M]
    rem: torch.Tensor        # f32   [M]
    cls: torch.Tensor        # int32 [M]

    @staticmethod
    def zero(M: int, device="cpu", cells: Optional[int] = None) -> "SQState":
        """Empty cluster of M servers (in each of ``cells`` cells)."""
        return SQState(torch.zeros(_lead(cells) + (M,), dtype=torch.int32,
                                   device=device),
                       *_idle_servers(M, device, cells))


class FCFSState(NamedTuple):
    """FCFS state: one central queue feeding all servers."""

    C: torch.Tensor          # int32 [] central queue length
    busy: torch.Tensor       # bool  [M]
    rem: torch.Tensor        # f32   [M]
    cls: torch.Tensor        # int32 [M]

    @staticmethod
    def zero(M: int, device="cpu", cells: Optional[int] = None) -> "FCFSState":
        """Empty cluster of M servers (in each of ``cells`` cells)."""
        return FCFSState(torch.zeros(_lead(cells), dtype=torch.int32,
                                     device=device),
                         *_idle_servers(M, device, cells))


_STATE_DTYPES = (torch.int32, torch.bool, torch.float32, torch.int32)


def state_from_numpy(kind, state, device="cpu"):
    """A ``kind`` state (``BPState``, ``SQState`` or ``FCFSState``) from its
    four arrays, e.g. the reference's state as numpy."""
    return kind(*(torch.tensor(np.asarray(x), dtype=d, device=device)
                  for x, d in zip(state, _STATE_DTYPES)))


def state_to_numpy(state):
    """The same state with numpy leaves."""
    return type(state)(*(x.cpu().numpy() for x in state))


def bp_state_from_numpy(state, device="cpu") -> BPState:
    """A ``BPState`` from four arrays (Q, busy, rem, cls)."""
    return state_from_numpy(BPState, state, device)


def sq_state_from_numpy(state, device="cpu") -> SQState:
    """An ``SQState`` from four arrays (Q, busy, rem, cls)."""
    return state_from_numpy(SQState, state, device)


bp_state_to_numpy = sq_state_to_numpy = state_to_numpy


def raw_sums_from_numpy(sums, device="cpu") -> RawSums:
    """``RawSums`` from 13 float32 arrays in field order."""
    return RawSums(*(torch.tensor(np.asarray(x), dtype=_F, device=device)
                     for x in sums))


def raw_sums_to_numpy(sums: RawSums) -> RawSums:
    """The same accumulators with numpy leaves."""
    return RawSums(*(x.cpu().numpy() for x in sums))


# ---------------------------------------------------------------------------
# The random-draw seam
# ---------------------------------------------------------------------------


class SlotDraws(NamedTuple):
    """Every random number one slot of the BP family consumes."""

    raw: torch.Tensor                          # int32 [] Poisson count, unclipped
    locals_: torch.Tensor                      # int32 [A, n_rep] replica triples
    cls: Optional[torch.Tensor]                # int32 [A, M] their locality
    #                                            classes (derived from locals_,
    #                                            not drawn; full BP only)
    dur: torch.Tensor                          # int32 [M, 3] duration per class
    prio: Optional[torch.Tensor] = None        # int32 [M] tie permutation
    #                                            (full BP, batched)
    tie_rnd: Optional[torch.Tensor] = None     # f32 [M] tie priority
    #                                            (full BP, sequential)
    cand_idx: Optional[torch.Tensor] = None    # int32 [A, C] candidates (pod)
    cand_valid: Optional[torch.Tensor] = None  # bool [A, C]
    cand_rnd: Optional[torch.Tensor] = None    # f32 [A, C] tie uniforms
    #                                            (pod, sequential)
    size_e: Optional[torch.Tensor] = None      # f32 [M] N(0, 1/2) draws of
    #                                            the size law (``_task_work``;
    #                                            size_sigma > 0 only)


class SQDraws(NamedTuple):
    """Every random number one slot of the SQ family consumes (S = min(s_max,
    M) scheduling rows, d' = pod.d probes)."""

    raw: torch.Tensor                     # int32 [] Poisson count, unclipped
    locals_: torch.Tensor                 # int32 [A, n_rep] replica triples
    dur: torch.Tensor                     # int32 [S, 3] duration per class
    tie: torch.Tensor                     # f32 [S, M] tie uniforms, or
    #                                       [S, 1 + d'] (pod)
    grant: torch.Tensor                   # f32 [S] grant tie uniforms
    rows: Optional[torch.Tensor] = None   # f32 [M] row priority (S < M)
    cand: Optional[torch.Tensor] = None   # int32 [S, d'] probe offsets: d_rack
    #                                       in [0, R - 1), then d_remote in
    #                                       [0, M - R) (pod)
    route: Optional[torch.Tensor] = None  # f32 [A, n_rep] route tie uniforms
    #                                       (sequential)
    size_e: Optional[torch.Tensor] = None  # f32 [S] size-law draws


class FCFSDraws(NamedTuple):
    """Every random number one slot of FCFS consumes (G = min(s_max, M))."""

    raw: torch.Tensor          # int32 [] Poisson count, unclipped
    rank: torch.Tensor         # f32 [M] grab order of the idle servers
    locals_: torch.Tensor      # int32 [G, n_rep] replicas of the grabbed tasks
    dur: torch.Tensor          # int32 [G, 3] duration per class
    size_e: Optional[torch.Tensor] = None  # f32 [G] size-law draws


def draw_durations(gen: torch.Generator, cfg: SimConfig, p: torch.Tensor,
                   n: int, rows: int) -> torch.Tensor:
    """int32 [n, rows, 3] service durations from ``gen`` (on the device of
    ``p``, the [3] class rates): one draw a row, evaluated for every class,
    under ``cfg.service_dist``."""
    dev = p.device
    if cfg.service_dist == GEOMETRIC:
        return durations_from_uniform(uniform_open(gen, (n, rows, 1), dev), p)
    if cfg.service_dist == LOGNORMAL:
        z = torch.randn((n, rows, 1), generator=gen, device=dev)
        return durations_from_normal(z, p, cfg.sigma)
    raise ValueError(f"unknown service distribution {cfg.service_dist!r}")


def _slot_view(buf, i: int, cluster: Optional[Cluster] = None):
    """Slot i of a filled draw block ``buf`` (every field [n, ...]): each
    field's row i.  With ``cluster`` (full BP), ``cls`` is derived from the
    slot's replica triples, the one place the port derives it: BP's
    [..., a_max, M] class grid is not drawn."""
    d = type(buf)(*(None if x is None else x[i] for x in buf))
    if cluster is None:
        return d
    with span("sim.draws.class_grid"):
        return d._replace(cls=locality_class(cluster, d.locals_))


class TorchDraws:
    """Default draw source of one cell: ``draws(t)`` is slot t's draws for
    ``family`` ("bp", "sq" or "fcfs"), in the reference's distributions,
    from a ``torch.Generator`` on the device of ``lam_t`` ([T] arrival
    intensity per slot).

    Draws are made for a block of slots at once (up to 256, fewer when a
    slot's largest draw, full JSQ's [S, M] ties or BP-Pod's candidate
    counting over [a_max, M], is large) and handed out as views, so a slot
    costs no generator launches of its own.  The block depends on the
    cell's shapes only, never on how many cells a grid runs, so that a grid
    cell draws exactly what its looped run draws.  The full-BP tie
    permutation is the argsort of iid uniforms: a uniform permutation.
    Bounded integers are scaled uniforms (``uniform_int``).  Full BP's
    class grid comes from ``_slot_view``.

    ``scen`` (a ScenarioData on the same device, or None for ``uniform``)
    sets the placement law of the replica triples, each slot drawing from
    its own churn epoch's popularity row, and, when its ``size_sigma`` is
    above 0, adds the size law's draws.  Uniform placement and sigma 0
    draw exactly what they draw without a scenario."""

    _BLOCK_ELEMS = 1 << 22      # elements of a block's largest draw

    def __init__(self, gen: torch.Generator, cluster: Cluster, rates: Rates,
                 cfg: SimConfig, pod: Optional[PodSpec], a_max: int,
                 lam_t: torch.Tensor, family: str = "bp",
                 scen: Optional[ScenarioData] = None):
        self.gen, self.cluster, self.cfg, self.pod = gen, cluster, cfg, pod
        self.a_max, self.lam_t, self.family = a_max, lam_t, family
        self.sequential = cfg.route_mode == "sequential"
        self.scen = scen
        self.cdf = None if scen is None else placement_cdf(scen)
        # read once a run: draw the size law only when it is on
        self.sized = (scen is not None and scen.size_sigma is not None
                      and float(scen.size_sigma) > 0.0)
        self.p = rates.as_array(lam_t.device)                     # [3]
        M, dev = cluster.M, lam_t.device
        self.S = min(cfg.s_max, M)
        bp = max(M, a_max * cluster.n_replicas) if pod is None else a_max * M
        lanes = {"bp": bp, "fcfs": M,
                 "sq": max(M, self.S * (M if pod is None else 1 + pod.d))}
        self.block = max(1, min(256, self._BLOCK_ELEMS // lanes[family]))
        if pod is not None and family == "bp":
            self.cand_cls = pod_candidate_classes(cluster.n_replicas, pod, dev)
        if pod is not None and family == "sq":
            R = cluster.rack_size
            self.cand_hi = torch.tensor([max(R - 1, 1)] * pod.d_rack
                                        + [max(M - R, 1)] * pod.d_remote,
                                        dtype=_F, device=dev)
        self._t0, self._buf = None, None

    def _dur(self, n: int, rows: int) -> torch.Tensor:
        """int32 [n, rows, 3]: one draw a row, evaluated for every class."""
        return draw_durations(self.gen, self.cfg, self.p, n, rows)

    def _locals(self, t0: int, n: int, rows: int) -> torch.Tensor:
        """int32 [n, rows, n_rep] replica triples of slots t0 .. t0 + n - 1
        under the placement law."""
        g, c, dev = self.gen, self.cluster, self.lam_t.device
        if self.cdf is None:
            return sample_locals(g, c, n * rows, dev).view(n, rows, -1)
        pe = (0 if self.scen.placement_epoch is None
              else self.scen.placement_epoch[t0:t0 + n])
        return sample_locals_scenario(g, c, self.scen, (n, rows), pe=pe,
                                      cdf=self.cdf)

    def _fill(self, t0: int):
        """Draws for slots t0 .. t0 + block - 1, each field [n, ...]."""
        with span("sim.draws.fill"):
            g, c, M = self.gen, self.cluster, self.cluster.M
            dev = self.lam_t.device
            rand = lambda *shape: torch.rand(shape, generator=g, device=dev)
            lam = self.lam_t[t0:t0 + self.block]
            n = lam.shape[0]
            raw = torch.poisson(lam, generator=g).to(torch.int32)
            size = lambda rows: ({"size_e": torch.randn(
                (n, rows), generator=g, device=dev) * _HALF_SQRT2}
                if self.sized else {})
            if self.family == "fcfs":
                return FCFSDraws(raw, rand(n, M), self._locals(t0, n, self.S),
                                 self._dur(n, self.S), **size(self.S))
            locals_ = self._locals(t0, n, self.a_max)
            if self.family == "sq":
                S, pod = self.S, self.pod
                extra = size(S)
                if S < M:
                    extra["rows"] = rand(n, M)
                if pod is not None:
                    extra["cand"] = uniform_int(g, (n, S, pod.d),
                                                self.cand_hi, dev)
                if self.sequential:
                    extra["route"] = rand(n, self.a_max, c.n_replicas)
                return SQDraws(raw, locals_, self._dur(n, S),
                               rand(n, S, M if pod is None else 1 + pod.d),
                               rand(n, S), **extra)
            dur = self._dur(n, M)
            extra = size(M)
            if self.pod is None and self.sequential:
                extra["tie_rnd"] = rand(n, M)
            elif self.pod is None:
                extra["prio"] = rand(n, M).argsort(dim=1).to(torch.int32)
            else:
                cls = locality_class(c, locals_)
                ci, _, cv = pod_candidates(g, c, locals_, cls, self.pod,
                                           cand_cls=self.cand_cls)
                extra.update(cand_idx=ci, cand_valid=cv)
                if self.sequential:
                    extra["cand_rnd"] = rand(*ci.shape)
            return SlotDraws(raw, locals_, None, dur, **extra)

    def __call__(self, t: int):
        if self._buf is None or not self._t0 <= t < self._t0 + self.block:
            self._t0, self._buf = t, self._fill(t)
        return _slot_view(self._buf, t - self._t0,
                          self.cluster if self.family == "bp"
                          and self.pod is None else None)


class GridDraws:
    """The draw source of N cells, a block of slots at a time: ``fill(t0)``
    is slots t0 .. t0 + block - 1 of every cell, each field [n, N, ...],
    and ``view(buf, i)`` slot i of it (``_slot_view``).  Cell i draws from
    ``cells[i]`` (a ``TorchDraws`` with its own generator, lam and
    scenario) in blocks of the same slots, stacked once a block.  Where
    only some cells draw the size law, the others get draws of 0, whose
    size multiplier is exactly 1."""

    def __init__(self, cells: list):
        first = cells[0]
        if any(c.block != first.block for c in cells):
            raise ValueError("the cells of a grid draw in blocks of one size")
        self.cells, self.block = cells, first.block
        self.sized = any(c.sized for c in cells)
        self._cluster = (first.cluster if first.family == "bp"
                         and first.pod is None else None)

    def fill(self, t0: int, out=None):
        """The block from slot t0; into ``out``'s buffers when given
        (``_stack_cells``)."""
        return _stack_cells([c._fill(t0) for c in self.cells], out)

    def view(self, buf, i: int):
        return _slot_view(buf, i, self._cluster)


class _CallerDraws:
    """A caller's per-slot draw source (``simulate(draws=...)``) as a draw
    source of one cell in blocks of one slot; its draws carry their own
    class grid."""

    block = 1
    view = staticmethod(_slot_view)

    def __init__(self, draws: DrawSource):
        self.draws = draws

    def fill(self, t0: int, out=None):
        return _stack_cells([_lift(self.draws(t0))], out)


def _stack_cells(parts, out=None):
    """One draws tuple from the cells' blocks: every field [n, ...] stacked
    to [n, N, ...]; a field some cells lack (the size law's) is 0 in
    those.  ``out``, a draws tuple of [block, N, ...] buffers, takes the
    stack in its first n rows, and those rows are returned."""
    def stack(xs, o):
        have = [x for x in xs if x is not None]
        if not have:
            return None
        xs = [torch.zeros_like(have[0]) if x is None else x for x in xs]
        if o is None:
            return xs[0][:, None] if len(xs) == 1 else torch.stack(xs, dim=1)
        o = o[:xs[0].shape[0]]
        return o.copy_(xs[0][:, None]) if len(xs) == 1 else \
            torch.stack(xs, dim=1, out=o)
    outs = (None,) * len(parts[0]) if out is None else out
    with span("sim.draws.stack"):
        return type(parts[0])(*(stack(xs, o)
                                for xs, o in zip(zip(*parts), outs)))


def _lift(x):
    """A one-cell value with a leading cell axis of 1: a tensor, or every
    tensor of a draws / state / sums tuple; anything else unchanged."""
    if torch.is_tensor(x):
        return x[None]
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*map(_lift, x))
    return x


def _drop(x):
    """The inverse of ``_lift`` on a result: the one cell's values (also
    through a plain tuple of results)."""
    if torch.is_tensor(x):
        return x[0]
    if isinstance(x, tuple):
        items = map(_drop, x)
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x


def _one_cell_too(is_one: Callable[..., bool]):
    """Let a function written for a leading cell axis also take one cell's
    unbatched positional arguments (``is_one(*args)`` says which): those
    are lifted to one cell, and the result's cell axis is dropped.  Keyword
    arguments pass through as they are (constants, rates and speeds are
    shared by every cell), except the cell's ``tele``, lifted as a view so
    that the collectors' in-place updates reach it."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kw):
            if not is_one(*args):
                return fn(*args, **kw)
            if kw.get("tele") is not None:
                kw["tele"] = _lift(kw["tele"])
            return _drop(fn(*map(_lift, args), **kw))
        return call
    return wrap


# ---------------------------------------------------------------------------
# Shared slot plumbing
# ---------------------------------------------------------------------------


def _speed_of_class(speed: torch.Tensor, cls: torch.Tensor) -> torch.Tensor:
    """[..., M] per-server speed for class ``cls[..., m]``; speed: [..., M,
    3] with the same leading dimensions."""
    return torch.gather(speed, -1, cls.to(torch.int64)[..., None])[..., 0]


def _progress_service(busy, rem, speed=None, cls=None):
    """Busy servers complete ``speed[m, cls[m]]`` work units this slot (cls
    = class of the in-flight task); speed None: unit speeds, the
    homogeneous fast path.  Returns (busy', rem', completed_mask)."""
    rem = torch.where(busy, rem - (1.0 if speed is None
                                   else _speed_of_class(speed, cls)), 0.0)
    completed = busy & (rem <= 0)
    busy = busy & ~completed
    rem = torch.where(busy, rem, 0.0)
    return busy, rem, completed


def _arrival_batch(draws, a_max: int):
    """Arrival mask [N, a_max] (Poisson count clipped to a_max) and the
    clipped count [N]."""
    n = torch.clamp_max(draws.raw, a_max)
    mask = torch.arange(a_max, device=n.device) < n[..., None]
    return mask, (draws.raw - n).to(_F)


def _rows_of(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x[n, rows[n]] for every cell n: x [N, M, ...], rows [N, S] ->
    [N, S, ...]."""
    idx = rows.to(torch.int64).reshape(rows.shape + (1,) * (x.ndim - 2))
    return torch.gather(x, 1, idx.expand(rows.shape + x.shape[2:]))


def _relation_rows(rack_of: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """[..., S, M] locality class of server rows[..., s] serving a task
    queued at (= local to) server n; ``rack_of`` is ``Cluster.rack_of`` on
    the device."""
    n = torch.arange(rack_of.shape[0], device=rows.device)
    same = rack_of[rows][..., None] == rack_of
    own = rows[..., None] == n
    return torch.where(own, LOCAL, torch.where(same, RACK, REMOTE))


def _acc(sums: RawSums, *, in_half2, N, arr, clipped, comp, starts,
         routed, busy_n, routes, scheds, measure) -> RawSums:
    """Add one slot to the accumulators.  ``measure`` and ``in_half2`` are
    0/1 weights: bools, or float32 tensors that broadcast against ``N`` (a
    captured slot reads them from the device).  Every weighted increment is
    exact and one weighted 0 adds 0.0, as the reference's does: the sums
    match its f32 values bit for bit.  All fields update in one packed
    add."""
    h2 = N * in_half2
    inc = torch.cat([torch.stack([
        torch.ones_like(N), N, N - h2, h2, arr, clipped, comp], dim=-1),
        starts, routed, torch.stack([busy_n, routes, scheds], dim=-1)], dim=-1)
    cur = torch.cat([torch.stack(sums[:7], dim=-1), sums.starts, sums.routed,
                     torch.stack(sums[9:12], dim=-1)], dim=-1)
    new = cur + inc * measure
    return RawSums(*new[..., :7].unbind(-1), new[..., 7:10], new[..., 10:13],
                   *new[..., 13:16].unbind(-1), final_N=N)


def _fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once, as a fused multiply-add (the
    product of two float32 values is exact in float64)."""
    f = lambda x: x.to(torch.float64) if torch.is_tensor(x) else x
    return (f(a) * f(b) + f(c)).to(_F)


_F32 = lambda x: float(np.float32(x))
_EXP_LOG2E, _EXP_C1, _EXP_C2 = _F32(1.44269504088896341), _F32(0.693359375), \
    _F32(-2.12194440e-4)
_EXP_P = tuple(_F32(p) for p in (1.9875691500e-4, 1.3981999507e-3,
                                 8.3334519073e-3, 4.1665795894e-2,
                                 1.6666665459e-1, 5.0000001201e-1))


def _exp_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 exp as XLA's CPU backend evaluates it: the Cephes polynomial
    with fused multiply-adds (``_fma32``), so that the size multiplier is
    the reference's to the bit on the CPU and the card alike (torch.exp
    differs from it in the last bit on many inputs).  Equal to XLA's for
    |x| < 87, far beyond what a size law reaches."""
    x = torch.clamp(x, -88.3762626647949, 88.3762626647950)
    fx = torch.floor(_fma32(x, _EXP_LOG2E, 0.5))
    r = _fma32(fx, -_EXP_C1, x)
    r = _fma32(fx, -_EXP_C2, r)
    y = _fma32(r, _EXP_P[0], _EXP_P[1])
    for p in _EXP_P[2:]:
        y = _fma32(y, r, p)
    y = _fma32(y, r * r, r) + 1.0
    return y * ((fx.to(torch.int32) + 127) << 23).view(_F)


_SQRT2 = _F32(math.sqrt(2.0))
_HALF_SQRT2 = _F32(math.sqrt(0.5))


def _task_work(dur: torch.Tensor, scen=None,
               e: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Float32 work units of freshly started tasks: the sampled duration
    times the scenario's size multiplier exp(size_mu + size_sigma * z), a
    mean-1 lognormal, z standard normal.  ``scen`` holds ``size_mu`` and
    ``size_sigma`` broadcasting against ``dur`` (a ScenarioData's scalars,
    or a ``SizeLaw`` of a grid's cells).  ``e`` is z / sqrt(2), an
    N(0, 1/2) draw: the reference draws z = sqrt(2) * erfinv(u), and XLA
    folds the sqrt(2) into sigma, evaluating exp(mu + (sigma * sqrt(2)) *
    erfinv(u)); the port computes the same expression on ``e = erfinv(u)``,
    so a test that passes the reference's erfinv(u) gets its work to the
    bit.  e None (a size_sigma of 0, where the reference's multiplier is
    exp(0) == 1): the duration itself, bit for bit."""
    work = dur.to(_F)
    if e is None:
        return work
    return work * _exp_f32(_fma32(e, scen.size_sigma * _SQRT2, scen.size_mu))


class SizeLaw(NamedTuple):
    """The size law of a grid's cells: ``size_mu`` and ``size_sigma`` [N,
    1] float32 (``_task_work``)."""

    size_mu: torch.Tensor
    size_sigma: torch.Tensor


def _class_hits(cls: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """bool [..., 3]: entry i has a hit at column cls[..., i] where
    on[..., i]."""
    return (cls[..., None] == torch.arange(3, device=cls.device)) & on[..., None]


# ---------------------------------------------------------------------------
# BP family
# ---------------------------------------------------------------------------


def _bp_workload(Q: torch.Tensor, inv_rates: torch.Tensor) -> torch.Tensor:
    """Paper §IV-A: W_m = Q^l/alpha_m + Q^k/beta_m + Q^r/gamma_m;
    non-finite (dead) entries contribute 0.  Q [..., M, 3]; inv_rates [3],
    [M, 3] or [..., M, 3]."""
    inv = inv_rates[None, :] if inv_rates.ndim == 1 else inv_rates
    return workload(Q, torch.where(torch.isfinite(inv), inv, 0.0))


def _bp_schedule(dur, Q, busy, rem, cls, servable=None, scen=None,
                 size_e=None):
    """Idle servers start their own head-of-class *servable* task: local >
    rack > remote among classes whose tier is up (purely local
    information, paper §IV-A).  Every cell at once: ``dur`` [N, M, 3]
    holds each server's duration for each class; ``servable`` bool [N, M,
    3] (speed > 0), None: all servable (the homogeneous fast path);
    ``scen`` and ``size_e`` the size law (``_task_work``).  Returns (Q',
    busy', rem', cls', starts_by_class [N, 3], n_started [N], pick [N, M],
    start [N, M]): pick and start let the sojourn rings mirror the pops."""
    has = Q > 0 if servable is None else (Q > 0) & servable
    pick = torch.argmax(has.to(torch.uint8), dim=-1)        # first nonempty
    start = ~busy & has.any(dim=-1)
    taken = _class_hits(pick, start)
    Q = Q - taken.to(torch.int32)
    d = torch.gather(dur, -1, pick[..., None])[..., 0]
    busy = busy | start
    rem = torch.where(start, _task_work(d, scen, size_e), rem)
    cls = torch.where(start, pick.to(torch.int32), cls)
    return (Q, busy, rem, cls, taken.sum(dim=-2).to(_F),
            start.sum(dim=-1).to(_F), pick, start)


def _full_bp_scores(W, cls_arr, inv_rates):
    """[..., M] weighted-workload score of every server for each arrival:
    what the O(M) policy would examine (the probe-quality oracle).  W and
    cls_arr [N, ..., M] (or W [N, M] for cls [N, M])."""
    m = torch.arange(cls_arr.shape[-1], device=cls_arr.device)
    return weighted_score(W, inv_rate_for(inv_rates, m, cls_arr))


def _bp_route_batch(draws: SlotDraws, Q, cls_arr, mask, inv_rates, pod,
                    sequential: bool, class_tiebreak: bool = True,
                    cand_cls: Optional[torch.Tensor] = None, tcfg=None,
                    cluster: Optional[Cluster] = None):
    """Route every cell's arrival batch; returns (Q', sel [N, A], sel_cls
    [N, A], probe): probe is (rank_sum, regret_sum, n_decisions) [N] when
    ``tcfg`` collects probes, else None.

    batched: one ``route_commit`` launch for all N cells (sequential
    commits inside each cell's batch; ties by class, then ``draws.prio`` /
    candidate slot); the probes rank each decision against the pre-commit
    workloads the kernel scored it with (``route_commit_wseq``).
    sequential: per-arrival plain routing, each arrival seeing the previous
    one's queues; random ties (``draws.tie_rnd`` / ``draws.cand_rnd``);
    arrival b of every cell routes in one set of ops, up to the largest
    arrival count of any cell (the cells with fewer commit nothing past
    theirs).  The probes need every arrival's class grid: full BP's draws
    carry it, BP-Pod's derive it from the replica triples (no draw)."""
    collect = tcfg is not None and tcfg.probes
    if collect and cls_arr is None:
        cls_arr = locality_class(cluster, draws.locals_)
    if not sequential:
        Q0 = Q
        if pod is None:
            Q, _W, sel, sel_cls, _val = route_commit(
                Q, mask, inv_rates, cls=cls_arr, prio=draws.prio)
        else:
            Q, _W, sel, sel_cls, _val = route_commit(
                Q, mask, inv_rates, cand_idx=draws.cand_idx,
                cand_cls=cand_cls, cand_valid=draws.cand_valid)
        probe = None
        if collect:
            full = _full_bp_scores(
                route_commit_wseq(Q0, sel, sel_cls, mask, inv_rates),
                cls_arr, inv_rates)                              # [N, A, M]
            chosen = full.gather(-1, sel.to(torch.int64)[..., None])[..., 0]
            probe = tlm.probe_stats_min(full, chosen, mask)
        return Q, sel, sel_cls, probe

    # arrivals after a cell's last valid one commit nothing and their
    # decisions are never read (routed counts are masked): route up to the
    # last valid one of any cell.  This reads the arrival counts on the
    # host, once per slot.
    n = int(mask.sum(dim=-1).max()) if mask.numel() else 0
    N = Q.shape[0]
    cells = torch.arange(N, device=Q.device)
    Q = Q.clone()
    sel = torch.zeros(mask.shape, dtype=torch.int32, device=Q.device)
    sel_cls = torch.zeros_like(sel)
    full = torch.empty((N, n, Q.shape[1]), dtype=_F, device=Q.device) \
        if collect else None
    for b in range(n):
        W = _bp_workload(Q, inv_rates)
        if pod is None:
            s, c = route_balanced_pandas_full(W, cls_arr[:, b], inv_rates,
                                              draws.tie_rnd, class_tiebreak)
        else:
            s, c = route_pod_candidates(draws.cand_rnd[:, b], W,
                                        draws.cand_idx[:, b],
                                        cand_cls[..., b, :].expand(N, -1),
                                        draws.cand_valid[:, b], inv_rates)
        if collect:     # scored against the queues arrival b saw
            full[:, b] = _full_bp_scores(W, cls_arr[:, b], inv_rates)
        Q.index_put_((cells, s.to(torch.int64), c.to(torch.int64)),
                     mask[:, b].to(torch.int32), accumulate=True)
        sel[:, b], sel_cls[:, b] = s, c
    probe = None
    if collect:
        chosen = full.gather(-1, sel[:, :n].to(torch.int64)[..., None])[..., 0]
        probe = tlm.probe_stats_min(full, chosen, mask[:, :n])
    return Q, sel, sel_cls, probe


def _one_state(state, *_) -> bool:
    """Does a step get one cell's unbatched state (busy is [M])?"""
    return state.busy.ndim == 1


@_one_cell_too(_one_state)
def _bp_step(state: BPState, sums: RawSums, draws: SlotDraws, *,
             cluster: Cluster, cfg: SimConfig, inv_rate_m: torch.Tensor,
             pod: Optional[PodSpec], a_max: int, measure: bool,
             in_half2: bool, class_tiebreak: bool = True,
             cand_cls: Optional[torch.Tensor] = None,
             speed: Optional[torch.Tensor] = None, scen=None,
             t: int = 0, tele: Optional[tlm.Telemetry] = None,
             tcfg: Optional[tlm.TelemetryConfig] = None):
    """One slot of the BP family in every cell: completions -> scheduling
    -> arrivals and routing -> accumulators.  State, sums and draws lead
    by the cell axis [N] (or are one cell's, unbatched).  ``speed`` is the
    slot's per-class speed, [M, 3] shared by every cell or [N, M, 3], with
    ``inv_rate_m`` the slot's inverse rates ([M, 3] or [N, M, 3], ``+inf``
    where a tier is down); speed None is the homogeneous path (unit
    speeds, the [3] vector).  ``scen`` carries the size law
    (``_task_work``).  ``cand_cls`` ([A, C] int32, shared; pod only) may
    be passed precomputed; full BP needs ``draws.cls``.  With ``tcfg``,
    slot ``t`` also feeds the collectors of ``tele`` (in place)."""
    N = state.Q.shape[0]
    if pod is not None and cand_cls is None:
        cand_cls = pod_candidate_classes(cluster.n_replicas, pod,
                                         state.Q.device).expand(
            a_max, -1).contiguous()
    with span("sim.step.service"):
        if speed is not None:
            speed = speed.expand(N, -1, -1)
        busy, rem, completed = _progress_service(state.busy, state.rem, speed,
                                                 state.cls)
        if tcfg is not None:
            # sojourn = completion slot - arrival slot of the task in service
            tlm.record_sojourns(tele, tcfg, t, cfg.warmup, completed)
    with span("sim.step.schedule"):
        Q, busy, rem, cls_serv, starts, n_started, pick, start = _bp_schedule(
            draws.dur, state.Q, busy, rem, state.cls,
            servable=None if speed is None else speed > 0, scen=scen,
            size_e=draws.size_e)
    if tcfg is not None and tele.ring is not None:
        with span("sim.step.telemetry"):
            m = torch.arange(cluster.M, device=Q.device)
            tlm.ring_pop(tele, tcfg, m * 3 + pick, start, m.expand(N, -1),
                         distinct=True)
    with span("sim.step.route"):
        mask, clipped = _arrival_batch(draws, a_max)
        Q, sel, sel_cls, probe = _bp_route_batch(
            draws, Q, draws.cls, mask, inv_rate_m, pod,
            sequential=(cfg.route_mode == "sequential"),
            class_tiebreak=class_tiebreak, cand_cls=cand_cls, tcfg=tcfg,
            cluster=cluster)
    if tcfg is not None:
        with span("sim.step.telemetry"):
            tlm.ring_push(tele, tcfg, sel.to(torch.int64) * 3 + sel_cls,
                          mask, t)

    with span("sim.step.accumulate"):
        routed = _class_hits(sel_cls, mask).sum(dim=-2).to(_F)
        busy_n = busy.sum(dim=-1).to(_F)
        Ns = Q.sum(dim=(-2, -1)).to(_F) + busy_n
        arr = mask.sum(dim=-1).to(_F)
        sums = _acc(sums, in_half2=in_half2, N=Ns, arr=arr, clipped=clipped,
                    comp=completed.sum(dim=-1).to(_F), starts=starts,
                    routed=routed, busy_n=busy_n, routes=arr,
                    scheds=n_started, measure=measure)
    if tcfg is not None:
        with span("sim.step.telemetry"):
            tlm.collect_step(
                tele, tcfg, t=t, T=cfg.T, N=Ns, q_mass=Q.sum(dim=-2),
                qlen=Q.sum(dim=-1), workload=_bp_workload(Q, inv_rate_m),
                arrivals=arr, clipped=clipped,
                completions=completed.sum(dim=-1), busy_n=busy_n,
                probe=probe or tlm.ZERO_PROBE)
    return BPState(Q, busy, rem, cls_serv), sums


# ---------------------------------------------------------------------------
# SQ family: JSQ-MaxWeight(-Pod) and JSQ-Priority
# ---------------------------------------------------------------------------


class StepConsts(NamedTuple):
    """Per-run device constants of the SQ and FCFS steps (``step_consts``):
    made once, so a slot copies nothing from the host."""

    rack_of: torch.Tensor      # int64 [M] Cluster.rack_of
    rates: torch.Tensor        # f32 [3] (alpha, beta, gamma)
    lane_cls: Optional[torch.Tensor]   # int64 [1 + d'] class of each
    #                                    JSQ-MW-Pod probe: own, rack, remote
    lane_rate: Optional[torch.Tensor]  # f32 [1 + d'] its rate
    unit_inv: torch.Tensor     # f32 [3] ones: batched JSQ's kernel operand,
    zero_cls: torch.Tensor     # int32 [a_max, n_rep] with class 0
    one_valid: torch.Tensor    # bool [a_max, n_rep] candidates all valid


def step_consts(cluster: Cluster, rates: Rates, pod: Optional[PodSpec],
                a_max: int, device) -> StepConsts:
    """The ``StepConsts`` of one run."""
    r = rates.as_array(device)
    lane = None if pod is None else pod_candidate_classes(1, pod, device).long()
    shape = (a_max, cluster.n_replicas)
    return StepConsts(cluster.rack_of.to(device=device, dtype=torch.int64), r,
                      lane, None if pod is None else r[lane],
                      torch.ones(3, dtype=_F, device=device),
                      torch.zeros(shape, dtype=torch.int32, device=device),
                      torch.ones(shape, dtype=torch.bool, device=device))


def _grant_conflicts(tgt, prio, has, Q, rnd):
    """Resolve batched steal conflicts among S claimants in every cell: at
    most Q[n] grants to queue n, higher-priority claimants first (prio =
    ascending sort keys, then the uniforms ``rnd`` [N, S]).  Returns bool
    [N, S] granted.

    Claimant i is granted iff its rank among same-target claimants is below
    Q[tgt[i]]; the rank is a pairwise count of [N, S, S] staged compares."""
    S = tgt.shape[-1]
    shape = tgt.shape[:-1] + (S, S)
    beats = torch.zeros(shape, dtype=torch.bool, device=tgt.device)
    eq = torch.ones(shape, dtype=torch.bool, device=tgt.device)
    for k in tuple(prio) + (rnd,):
        # beats[.., i, j]: claimant j precedes i in (prio..., rnd) order
        beats = beats | (eq & (k[..., None, :] < k[..., :, None]))
        eq = eq & (k[..., None, :] == k[..., :, None])
    same = ((tgt[..., None, :] == tgt[..., :, None]) & has[..., None, :]
            & has[..., :, None])
    rank = (same & beats).sum(dim=-1)
    return has & (rank < take_last(Q, tgt))


@_one_cell_too(lambda draws, cluster, Q, *_: Q.ndim == 1)
def _sq_schedule(draws: SQDraws, cluster: Cluster, Q, busy, rem, cls, *,
                 consts: StepConsts, S: int, variant: str,
                 pod: Optional[PodSpec], speed: Optional[torch.Tensor] = None,
                 scen=None, tcfg: Optional[tlm.TelemetryConfig] = None):
    """Batched scheduling of the SQ family, in every cell at once (Q, busy,
    rem, cls [N, M]; or one cell's, unbatched).

    variant "maxweight": argmax of rate-weighted queue lengths over all M
    (``pod`` None) or over own + d' sampled queues, each weighted by the
    serving server's own per-class speed; "priority": own > longest in
    rack > longest anywhere.  S == M takes every server as a row; S < M the
    first S eligible servers in the order of ``draws.rows`` (a stable
    argsort of each cell's row).  ``speed`` [M, 3] or [N, M, 3]: a
    (server, queue) pair whose class tier is down is ineligible and a
    server with every tier down schedules nothing; None is the homogeneous
    path.  ``scen`` carries the size law.  Returns (Q', busy', rem', cls',
    starts [N, 3], n_decisions [N], rows, tgt, granted), and with ``tcfg``
    a tenth entry, the probe (rank_sum, regret_sum, n) [N]: MaxWeight's
    pick ranked against the [S, M] weights the O(M) MaxWeight examines
    (None where probes are off or for JSQ-Priority)."""
    N, M = Q.shape
    idle = ~busy
    anyq = (Q > 0).any(dim=-1, keepdim=True)
    eligible = idle & ((Q > 0) | anyq)
    if speed is not None:
        speed = speed.expand(N, -1, -1)
        eligible = eligible & (speed > 0).any(dim=-1)
    if S == M:
        # every server is its own scheduling attempt (row order is
        # immaterial: grants tie-break on explicit uniforms)
        rows = torch.arange(M, device=Q.device).expand(N, M)
        act = eligible
    else:
        # up to S eligible servers in random order (the rest retry next
        # slot); ineligible servers tie at +inf, a stable sort keeps them
        # in index order as the reference's does
        rkey = torch.where(eligible, draws.rows, _INF)
        rows = torch.argsort(rkey, dim=-1, stable=True)[:, :S]
        act = eligible.gather(-1, rows)
    sp_rows = None if speed is None else _rows_of(speed, rows)   # [N, S, 3]

    collect = tcfg is not None and tcfg.probes
    probe = None
    qf = Q.to(_F)
    if variant == "maxweight" and pod is None:
        rel = _relation_rows(consts.rack_of, rows)              # [N, S, M]
        w = qf[:, None, :] * consts.rates[rel]
        if speed is None:
            cand = (Q > 0)[:, None, :].expand(N, S, M)
        else:
            sp = sp_rows.gather(-1, rel)        # the serving server's speed
            w = w * sp
            cand = (Q > 0)[:, None, :] & (sp > 0)
        tgt = lex_argmax(w, draws.tie, mask=cand).long()
        val = w.gather(-1, tgt[..., None])[..., 0]
        has = cand.any(dim=-1) & act
        prio = (-val,)
        if collect:     # full MaxWeight is the O(M) oracle itself: rank 0
            probe = tlm.probe_stats_max(w, val, has, cand)
    elif variant == "maxweight":
        u = draws.cand
        cand_idx = torch.cat([rows[..., None],
                              rack_peer_of(cluster, rows, u[..., :pod.d_rack]),
                              remote_peer_of(cluster, rows, u[..., pod.d_rack:])],
                             dim=-1)
        qc = take_last(Q, cand_idx)
        w = qc.to(_F) * consts.lane_rate
        cand = qc > 0
        if speed is not None:
            sp = sp_rows[..., consts.lane_cls]
            w = w * sp
            cand = cand & (sp > 0)
        c = lex_argmax(w, draws.tie, mask=cand).long()[..., None]
        tgt = cand_idx.gather(-1, c)[..., 0]
        val = w.gather(-1, c)[..., 0]
        has = cand.any(dim=-1) & act
        prio = (-val,)
        if collect:     # rank the 1 + d' pick against the full [S, M] oracle
            rel_f = _relation_rows(consts.rack_of, rows)
            w_f = qf[:, None, :] * consts.rates[rel_f]
            elig = (Q > 0)[:, None, :].expand(N, S, M)
            if speed is not None:
                sp_f = sp_rows.gather(-1, rel_f)
                w_f = w_f * sp_f
                elig = elig & (sp_f > 0)
            probe = tlm.probe_stats_max(w_f, val, has, elig)
    elif variant == "priority":
        rel = _relation_rows(consts.rack_of, rows)              # [N, S, M]
        nonempty = (Q > 0)[:, None, :]
        own_has = Q.gather(-1, rows) > 0
        if speed is not None:
            nonempty = nonempty & (sp_rows.gather(-1, rel) > 0)
            own_has = own_has & (sp_rows[..., LOCAL] > 0)
        rack_set = (rel == RACK) & nonempty
        glob_set = (rel == REMOTE) & nonempty
        wq = qf[:, None, :].expand(N, S, M)
        rack_tgt = lex_argmax(wq, draws.tie, mask=rack_set).long()
        glob_tgt = lex_argmax(wq, draws.tie, mask=glob_set).long()
        rack_any = rack_set.any(dim=-1)
        glob_any = glob_set.any(dim=-1)
        tgt = torch.where(own_has, rows,
                          torch.where(rack_any, rack_tgt, glob_tgt))
        has = (own_has | rack_any | glob_any) & act
        class_rank = torch.where(own_has, 0.0, torch.where(rack_any, 1.0, 2.0))
        prio = (class_rank, -qf.gather(-1, tgt))
    else:
        raise ValueError(variant)

    granted = _grant_conflicts(tgt, prio, has, Q, draws.grant)
    Q = Q.scatter_add(-1, tgt, -granted.to(torch.int32))
    # locality class of (server rows[s], queue tgt[s]): pairwise, O(S)
    rack_of = consts.rack_of
    start_cls = torch.where(rows == tgt, LOCAL,
                            torch.where(rack_of[rows] == rack_of[tgt],
                                        RACK, REMOTE))
    work = _task_work(draws.dur.gather(-1, start_cls[..., None])[..., 0],
                      scen, draws.size_e)
    start_cls32 = start_cls.to(torch.int32)
    if S == M:
        # rows == arange(M): the per-row scatters are identity placements
        busy = busy | granted
        rem = torch.where(granted, work, rem)
        cls = torch.where(granted, start_cls32, cls)
    else:
        busy = busy.scatter(-1, rows, busy.gather(-1, rows) | granted)
        rem = rem.scatter(-1, rows, torch.where(granted, work,
                                                rem.gather(-1, rows)))
        cls = cls.scatter(-1, rows, torch.where(granted, start_cls32,
                                                cls.gather(-1, rows)))
    starts = _class_hits(start_cls, granted).sum(dim=-2).to(_F)
    out = (Q, busy, rem, cls, starts, has.sum(dim=-1).to(_F), rows, tgt,
           granted)
    return out if tcfg is None else out + (probe,)


def _jsq_route_sequential(draws: SQDraws, Q, mask):
    """Per-arrival join-the-shortest-local-queue in every cell, random
    ties, each arrival seeing the previous one's commit.  Routes up to the
    largest arrival count of any cell (the rest commit nothing): reads the
    arrival counts on the host, once a slot.  Returns (Q', sel [N, A]),
    sel 0 past the routed arrivals."""
    n = int(mask.sum(dim=-1).max()) if mask.numel() else 0
    cells = torch.arange(Q.shape[0], device=Q.device)
    Q = Q.clone()
    sel = torch.zeros(mask.shape, dtype=torch.int64, device=Q.device)
    for b in range(n):
        s = route_jsq_local(draws.route[:, b], Q, draws.locals_[:, b])
        Q.index_put_((cells, s.to(torch.int64)), mask[:, b].to(torch.int32),
                     accumulate=True)
        sel[:, b] = s
    return Q, sel


@_one_cell_too(_one_state)
def _sq_step(state: SQState, sums: RawSums, draws: SQDraws, *,
             cluster: Cluster, cfg: SimConfig, consts: StepConsts,
             variant: str, pod: Optional[PodSpec], a_max: int, measure: bool,
             in_half2: bool, speed: Optional[torch.Tensor] = None,
             scen=None, t: int = 0, tele: Optional[tlm.Telemetry] = None,
             tcfg: Optional[tlm.TelemetryConfig] = None):
    """One slot of the SQ family in every cell: completions -> scheduling
    -> arrivals and routing -> accumulators (cells, ``speed``, ``scen`` and
    the telemetry as in ``_bp_step``).  Batched routing is one pod
    ``route_commit`` launch for all cells with unit rates on every fleet, as
    in the reference (JSQ routing is workload-free): Q embedded in column 0
    of an [N, M, 3] queue, the replica triples as candidates of class 0,
    all valid (ties by replica slot; the class and valid operands shared by
    every cell)."""
    with span("sim.step.service"):
        busy, rem, completed = _progress_service(
            state.busy, state.rem,
            None if speed is None else speed.expand(state.Q.shape[0], -1, -1),
            state.cls)
        if tcfg is not None:
            tlm.record_sojourns(tele, tcfg, t, cfg.warmup, completed)
    with span("sim.step.schedule"):
        Q, busy, rem, cls_serv, starts, n_sched, rows, tgt, granted, *probe = \
            _sq_schedule(draws, cluster, state.Q, busy, rem, state.cls,
                         consts=consts, S=min(cfg.s_max, cluster.M),
                         variant=variant, pod=pod, speed=speed, scen=scen,
                         tcfg=tcfg)
    if tcfg is not None:
        with span("sim.step.telemetry"):
            tlm.ring_pop(tele, tcfg, tgt, granted, rows)
    with span("sim.step.route"):
        mask, clipped = _arrival_batch(draws, a_max)
        if cfg.route_mode == "sequential":
            Q, sel = _jsq_route_sequential(draws, Q, mask)
        else:
            Q3, _W, sel, _scls, _val = route_commit(
                torch.nn.functional.pad(Q[..., None], (0, 2)), mask,
                consts.unit_inv, cand_idx=draws.locals_,
                cand_cls=consts.zero_cls, cand_valid=consts.one_valid)
            Q = Q3[..., 0]
    if tcfg is not None:
        with span("sim.step.telemetry"):
            tlm.ring_push(tele, tcfg, sel, mask, t)

    with span("sim.step.accumulate"):
        busy_n = busy.sum(dim=-1).to(_F)
        Ns = Q.sum(dim=-1).to(_F) + busy_n
        arr = mask.sum(dim=-1).to(_F)
        sums = _acc(sums, in_half2=in_half2, N=Ns, arr=arr, clipped=clipped,
                    comp=completed.sum(dim=-1).to(_F), starts=starts,
                    routed=torch.zeros_like(starts), busy_n=busy_n,
                    routes=arr, scheds=n_sched, measure=measure)
    if tcfg is not None:
        with span("sim.step.telemetry"):
            # workload proxy: queued work at the local rate (JSQ queues are
            # local to their server); drained servers contribute 0
            if speed is None:
                inv_l = safe_inv_rates(consts.rates)[LOCAL]
            else:
                inv_l = safe_inv_rates(speed[..., LOCAL] * consts.rates[LOCAL])
            inv_l = torch.where(torch.isfinite(inv_l), inv_l, 0.0)
            zero = torch.zeros_like(Ns)
            tlm.collect_step(
                tele, tcfg, t=t, T=cfg.T, N=Ns,
                q_mass=torch.stack([Q.sum(dim=-1).to(_F), zero, zero], dim=-1),
                qlen=Q, workload=Q.to(_F) * inv_l, arrivals=arr,
                clipped=clipped, completions=completed.sum(dim=-1),
                busy_n=busy_n, probe=probe[0] or tlm.ZERO_PROBE)
    return SQState(Q, busy, rem, cls_serv), sums


# ---------------------------------------------------------------------------
# FCFS: central queue, idle servers grab the head task
# ---------------------------------------------------------------------------


@_one_cell_too(_one_state)
def _fcfs_step(state: FCFSState, sums: RawSums, draws: FCFSDraws, *,
               cluster: Cluster, cfg: SimConfig, consts: StepConsts,
               a_max: int, measure: bool, in_half2: bool,
               speed: Optional[torch.Tensor] = None, scen=None, t: int = 0,
               tele: Optional[tlm.Telemetry] = None,
               tcfg: Optional[tlm.TelemetryConfig] = None):
    """One slot of FCFS in every cell: up to G = min(s_max, M) idle
    servers, in the random order of ``draws.rank``, each grab the head
    task; the grabbed task's replicas are sampled at dequeue (iid of
    everything else, so the law is the same).  With ``speed``, a server
    with every tier down is not idle, and one whose tier for the task's
    class is down leaves it queued.  Launches no kernel.  Telemetry: the
    windows only (no per-task identity to keep in a ring)."""
    G = min(cfg.s_max, cluster.M)
    N = state.busy.shape[0]
    with span("sim.step.service"):
        if speed is not None:
            speed = speed.expand(N, -1, -1)
        busy, rem, completed = _progress_service(state.busy, state.rem, speed,
                                                 state.cls)
    with span("sim.step.schedule"):
        idle = ~busy if speed is None else ~busy & (speed > 0).any(dim=-1)
        r = torch.where(idle, draws.rank, _INF)
        rows = torch.argsort(r, dim=-1, stable=True)[:, :G]         # [N, G]
        locals_g = draws.locals_.to(torch.int64)              # [N, G, n_rep]
        rack_of = consts.rack_of
        is_local = (locals_g == rows[..., None]).any(dim=-1)
        in_rack = (rack_of[locals_g] == rack_of[rows][..., None]).any(dim=-1)
        start_cls = torch.where(is_local, LOCAL,
                                torch.where(in_rack, RACK, REMOTE))
        grant = idle.gather(-1, rows) & (
            torch.arange(G, device=rows.device) < state.C[:, None])
        if speed is not None:
            grant = grant & (_rows_of(speed, rows).gather(
                -1, start_cls[..., None])[..., 0] > 0)
        work = _task_work(draws.dur.gather(-1, start_cls[..., None])[..., 0],
                          scen, draws.size_e)
        C = state.C - grant.sum(dim=-1).to(torch.int32)
        busy = busy.scatter(-1, rows, busy.gather(-1, rows) | grant)
        rem = rem.scatter(-1, rows,
                          torch.where(grant, work, rem.gather(-1, rows)))
        cls = state.cls.scatter(-1, rows, torch.where(
            grant, start_cls.to(torch.int32), state.cls.gather(-1, rows)))
        starts = _class_hits(start_cls, grant).sum(dim=-2).to(_F)

    with span("sim.step.route"):
        mask, clipped = _arrival_batch(draws, a_max)
        C = C + mask.sum(dim=-1).to(torch.int32)

    with span("sim.step.accumulate"):
        busy_n = busy.sum(dim=-1).to(_F)
        Ns = C.to(_F) + busy_n
        zero = torch.zeros_like(busy_n)
        sums = _acc(sums, in_half2=in_half2, N=Ns,
                    arr=mask.sum(dim=-1).to(_F), clipped=clipped,
                    comp=completed.sum(dim=-1).to(_F), starts=starts,
                    routed=torch.zeros_like(starts), busy_n=busy_n,
                    routes=zero, scheds=grant.sum(dim=-1).to(_F),
                    measure=measure)
    if tcfg is not None:
        with span("sim.step.telemetry"):
            tlm.collect_step(
                tele, tcfg, t=t, T=cfg.T, N=Ns,
                q_mass=torch.stack([C.to(_F), zero, zero], dim=-1),
                qlen=C[:, None], workload=None, arrivals=mask.sum(dim=-1),
                clipped=clipped, completions=completed.sum(dim=-1),
                busy_n=busy_n, probe=tlm.ZERO_PROBE)
    return FCFSState(C, busy, rem, cls), sums


# ---------------------------------------------------------------------------
# Algorithm registry + entry point
# ---------------------------------------------------------------------------

# paper §V parameters: d = 8 = (2 rack-local + 6 remote) for BP-Pod routing;
# d' = 12 = (6 + 6) for JSQ-MW-Pod scheduling.
BP_POD_DEFAULT = PodSpec(d_rack=2, d_remote=6)
JSQMW_POD_DEFAULT = PodSpec(d_rack=6, d_remote=6)

ALGORITHMS = (
    "fcfs",
    "jsq_priority",
    "jsq_maxweight",
    "jsq_maxweight_pod",
    "balanced_pandas",
    "balanced_pandas_pod",
)


def _family(algo: str) -> str:
    if algo in ("balanced_pandas", "balanced_pandas_pod",
                "balanced_pandas_randomtie"):
        return "bp"
    if algo == "fcfs":
        return "fcfs"
    if algo in ("jsq_maxweight", "jsq_maxweight_pod", "jsq_priority"):
        return "sq"
    raise ValueError(f"unknown algorithm {algo!r}")


def _pod_for(algo: str, pod: Optional[PodSpec]) -> Optional[PodSpec]:
    if pod is not None:
        return pod
    if algo == "balanced_pandas_pod":
        return BP_POD_DEFAULT
    if algo == "jsq_maxweight_pod":
        return JSQMW_POD_DEFAULT
    return None


DrawSource = Callable[[int], NamedTuple]     # slot index -> that slot's draws


def _rates_homogeneous(scen: Optional[ScenarioData]) -> bool:
    """Does this realization leave every server at the base rates for the
    whole run?  True only without windows and with unit base speeds: then
    the slot loop takes the homogeneous path (unit speeds, no masks, the
    [3] inverse-rate vector on ``route_commit``), with the same results.
    Padded realizations always carry window rows, so this is False for
    them, as in the reference.  Reads base_speed on the host once."""
    return scen is None or (scen.win_start.shape[0] == 0
                            and bool((scen.base_speed == 1.0).all()))


# what ``speed_at`` reads of a ScenarioData: the loop's operands off the
# homogeneous path, with the rate vector
_SPEED_OPERANDS = ("base_speed", "win_start", "win_end", "win_mult")


def _speed_step(state, sums: RawSums, *, step, bp: bool, t, rate_vec,
                base_speed, win_start, win_end, win_mult, **kw):
    """``step`` of slot ``t`` off the homogeneous path, at that slot's
    speeds from the scenario's operands: ``speed``, ``speed_at`` ([M, 3]
    shared by every cell, or a stacked scenario's [S, M, 3] expanded to
    [cells, M, 3], one row a scenario -> one row a cell), and for the BP
    family (``bp``) ``inv_rate_m``, the slot's inverse rates.  ``t`` is a
    Python int in an eager step and a 0-d device tensor in a captured one:
    nothing is read on the host, and both compute the same bits."""
    with span("sim.scenario.speed"):
        scen = ScenarioData(None, base_speed, win_start, win_end, win_mult,
                            None, None)
        speed = speed_at(scen, t)
        if speed.ndim == 3:
            S, M = speed.shape[:2]
            n = state.busy.shape[0]
            speed = speed[:, None].expand(S, n // S, M, 3).reshape(n, M, 3)
        slot = {"speed": speed}
        if bp:
            slot["inv_rate_m"] = safe_inv_rates(speed * rate_vec)
    return step(state, sums, t=t, **kw, **slot)


# ---------------------------------------------------------------------------
# The slot step as CUDA graphs
# ---------------------------------------------------------------------------

_GRAPH_SLOTS = 8        # slots one captured graph advances
_GRAPH_KEYS = 4         # sets of shapes whose graphs are kept (each holds a
#                         memory pool on the card)
_GRAPHS: "collections.OrderedDict[tuple, _SlotGraphs]" = collections.OrderedDict()


def _captures(device: torch.device, algo: str, route_mode: str, sized: bool,
              telemetry: bool, grid_draws: bool, T: int, block: int) -> bool:
    """Does the slot loop replay the slot step as CUDA graphs
    (``_SlotGraphs``)?  Only for the BP family's batched routing on a CUDA
    device, without a size law or telemetry, from the default draw source
    (``GridDraws``, ``block`` slots a fill) and for at least one whole
    block; on the homogeneous path and off it alike (off it the graphs
    also compute each slot's speeds, ``_speed_step``).  Everything else
    steps eagerly: the SQ family and FCFS, sequential routing (it reads
    each slot's arrival count on the host), a size law, the collectors, a
    caller's ``draws``, the CPU, and calls shorter than a block."""
    return (device.type == "cuda" and _family(algo) == "bp"
            and route_mode == "batched" and not sized
            and not telemetry and grid_draws and T >= block)


def _launch_counts() -> tuple:
    """A copy of the kernels' launch counters."""
    return dict(LAUNCHES), dict(MATRIX_LAUNCHES)


def _add_launches(counts: tuple) -> None:
    """Add ``counts`` (``_launch_counts``) to the launch counters."""
    for total, add in zip((LAUNCHES, MATRIX_LAUNCHES), counts):
        for k, v in add.items():
            total[k] += v


class _SlotGraphs:
    """The BP family's batched slot step captured as CUDA graphs, for one
    set of shapes (the slot loop's key).  The graphs read and write only
    tensors held here, refilled for every call by ``copy_``: the state and
    sums they advance, the loop's operands (``fixed``), one draw block's
    buffers ([block, N, ...], the draw source's ``fill`` writes them), the
    block's slot indices and its slots' 0/1 weights (``_acc``), so one
    graph serves every slot of a run.  Off the homogeneous path ``fixed``
    holds the scenario's speed operands and each captured slot computes
    its speeds from them and its slot index (``_speed_step``); nothing in
    a homogeneous graph reads the index.

    Chunk k's graph runs the slots at positions k * G .. k * G + G - 1 of
    the block (G = ``_GRAPH_SLOTS``), each chunk on the previous one's
    outputs; the block's last chunk copies its own back into the held state
    and sums, which the next block's first chunk reads.  The graphs share
    one memory pool and always replay in the order they were captured: a
    partial block replays those of its chunks that it holds whole.  A
    slot's draws are the draw source's ``view`` of the held buffers (full
    BP's class grid derived inside the graph).  ``LAUNCHES`` counts what a
    replay holds: launches made while capturing are taken back, and each
    replay adds its graph's."""

    def __init__(self, state, sums: RawSums, fixed: dict, draws, view):
        dev = state.busy.device
        self.state = type(state)(*map(torch.empty_like, state))
        self.sums = RawSums(*map(torch.empty_like, sums))
        self.fixed = {k: torch.empty_like(v) for k, v in fixed.items()}
        # held copies of the first block's draws, a whole block (T >= block)
        self.draws = type(draws)(*(
            None if x is None else x.clone(memory_format=torch.contiguous_format)
            for x in draws))
        self.block = block = draws.raw.shape[0]
        self.weights = torch.empty((2, block), dtype=_F, device=dev)
        self.slots = torch.empty(block, dtype=torch.int64, device=dev)
        self.view = view
        self.chunks = [(s, min(_GRAPH_SLOTS, block - s))
                       for s in range(0, block, _GRAPH_SLOTS)]
        self.graphs = []    # (graph, launches it holds, state and sums it leaves)

    def load(self, state, sums: RawSums, fixed: dict) -> None:
        """A call's initial state and sums and its constant operands."""
        for dst, src in zip(self.state + self.sums, state + sums):
            dst.copy_(src)
        for k, v in fixed.items():
            self.fixed[k].copy_(v)

    def _slot(self, i: int) -> dict:
        """The step's arguments of slot i of the block, views of the held
        buffers: its draws, slot index and weights."""
        return dict(draws=self.view(self.draws, i), t=self.slots[i],
                    measure=self.weights[0, i], in_half2=self.weights[1, i])

    def capture(self, step) -> None:
        """Capture every chunk of the block, after one eager step on scratch
        state that readies the step's kernels; nothing is computed."""
        step = functools.partial(step, **self.fixed)
        saved = _launch_counts()
        main = torch.cuda.current_stream(self.weights.device)
        side = torch.cuda.Stream(self.weights.device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            step(type(self.state)(*(x.clone() for x in self.state)),
                 RawSums(*(x.clone() for x in self.sums)), **self._slot(0))
            torch.cuda.synchronize(self.weights.device)
            pool = torch.cuda.graph_pool_handle()
            state, sums = self.state, self.sums
            for s, n in self.chunks:
                graph = torch.cuda.CUDAGraph()
                reset_launch_counts()
                graph.capture_begin(pool=pool)
                for i in range(s, s + n):
                    state, sums = step(state, sums, **self._slot(i))
                if s + n == self.block:
                    for dst, src in zip(self.state + self.sums, state + sums):
                        dst.copy_(src)
                    state, sums = self.state, self.sums
                graph.capture_end()
                self.graphs.append((graph, _launch_counts(), state, sums))
        main.wait_stream(side)
        reset_launch_counts()
        _add_launches(saved)

    def replay(self, n: int):
        """Replay every chunk that lies inside the block's first n slots,
        from the held state.  Returns the state and sums they leave and the
        number of slots they ran."""
        state, sums, done = self.state, self.sums, 0
        for (s, m), (graph, launches, st, sm) in zip(self.chunks, self.graphs):
            if s + m > n:
                break
            graph.replay()
            _add_launches(launches)
            state, sums, done = st, sm, s + m
        return state, sums, done


def _slot_loop(draw, step, state, sums: RawSums, fixed: dict, cfg: SimConfig,
               key: Optional[tuple] = None) -> RawSums:
    """The T-slot loop, a draw block at a time: each block is filled
    (``draw.fill``), then its slots run.  With ``key`` (``_captures``
    holds) the fill is one ``sim.draws`` span, the block's whole chunks
    replay the ``_SlotGraphs`` of ``key`` (captured in the first block of a
    key's first call) and the slots after them step eagerly; without it
    every slot steps eagerly, its draws in a ``sim.draws`` span of its own
    (the block's fill inside its first slot's).  An eager step gets the
    Python slot index and bool weights, a replayed one the held index and
    weights; both get the operands ``fixed`` and the draw source's
    ``view`` of the block.
    Nothing in a replayed loop reads the device on the host, so the host
    fills block k + 1 while the card runs block k.  Returns the sums."""
    B, half2_from = draw.block, cfg.warmup + (cfg.T - cfg.warmup) // 2
    entry = None
    if key is not None:
        slots = torch.arange(-(-cfg.T // B) * B, device=state.busy.device)
        weights = torch.stack([slots >= cfg.warmup,
                               slots >= half2_from]).to(_F)
        entry = _GRAPHS.pop(key, None)
    for t0 in range(0, cfg.T, B):
        n, done = min(B, cfg.T - t0), 0
        if key is not None:
            with span("sim.draws"):
                buf = draw.fill(t0, None if entry is None else entry.draws)
                if entry is None:
                    entry = _SlotGraphs(state, sums, fixed, buf, draw.view)
                entry.weights.copy_(weights[:, t0:t0 + B])
                entry.slots.copy_(slots[t0:t0 + B])
            if t0 == 0:
                entry.load(state, sums, fixed)
            if not entry.graphs:
                entry.capture(step)
            state, sums, done = entry.replay(n)
        for i in range(done, n):
            t = t0 + i
            if key is None:
                with span("sim.draws"):
                    if i == 0:
                        buf = draw.fill(t0, None)
                    d = draw.view(buf, i)
            else:
                d = draw.view(buf, i)
            state, sums = step(state, sums, draws=d, t=t,
                               measure=t >= cfg.warmup,
                               in_half2=t >= half2_from, **fixed)
    if key is None:
        return sums
    _GRAPHS[key] = entry
    while len(_GRAPHS) > _GRAPH_KEYS:
        _GRAPHS.popitem(last=False)
    return RawSums(*(x.clone() for x in sums))      # out of the held buffers


def _run(cells: Callable[[], tuple], dev: torch.device, *, algo: str,
         cluster: Cluster, rates: Rates, cfg: SimConfig,
         pod: Optional[PodSpec], a_max: int, n_cells: int,
         scen: Optional[ScenarioData] = None, homo: bool = True,
         tcfg: Optional[tlm.TelemetryConfig] = None):
    """The T-slot loop over ``n_cells`` cells (``_slot_loop``); returns
    (raw accumulators, telemetry or None), each leaf with a leading
    [cells].  ``cells()`` gives (draw, size): ``draw`` a draw source
    (``GridDraws``, or ``_CallerDraws``), ``size`` the cells' size law
    (``_task_work``); it runs with the rest of the loop's set-up, in the
    span ``sim.grid.cells``.  ``scen`` is one ScenarioData all cells share,
    or a stacked one of S scenarios whose row s the cells s * cells / S ..
    (s + 1) * cells / S - 1 read.  The loop's operands are one dict for
    every step: on the homogeneous path (``homo``) the BP family's [3]
    inverse rates; off it the scenario's speed operands and the rate
    vector, from which each slot computes its speeds (``_speed_step``).
    ``tcfg``: collect telemetry."""
    family = _family(algo)
    M = cluster.M
    with span("sim.grid.cells"):
        draw, size = cells()
        rate_vec = rates.as_array(dev)
        kw = dict(cluster=cluster, cfg=cfg, a_max=a_max, scen=size)
        fixed = {}
        if family == "bp":
            if pod is not None:
                fixed["cand_cls"] = pod_candidate_classes(
                    cluster.n_replicas, pod, dev).expand(a_max, -1).contiguous()
            state = BPState.zero(M, dev, n_cells)
            step = functools.partial(
                _bp_step, pod=pod,
                class_tiebreak=(algo != "balanced_pandas_randomtie"), **kw)
        else:
            consts = step_consts(cluster, rates, pod, a_max, dev)
            if family == "sq":
                state = SQState.zero(M, dev, n_cells)
                step = functools.partial(
                    _sq_step, consts=consts, pod=pod,
                    variant="priority" if algo == "jsq_priority"
                    else "maxweight", **kw)
            else:
                state = FCFSState.zero(M, dev, n_cells)
                step = functools.partial(_fcfs_step, consts=consts, **kw)
        sums = RawSums.zero(dev, n_cells)
        tele = None
        if tcfg is not None:
            tele = tlm.zero_telemetry(tcfg, M, family, device=dev,
                                      cells=n_cells)
            step = functools.partial(step, tele=tele, tcfg=tcfg)
        if homo:
            if family == "bp":
                fixed["inv_rate_m"] = safe_inv_rates(rate_vec)
        else:
            fixed.update(rate_vec=rate_vec,
                         **{k: getattr(scen, k) for k in _SPEED_OPERANDS})
            step = functools.partial(_speed_step, step=step,
                                     bp=family == "bp")
        grid = isinstance(draw, GridDraws)
        key = None
        if _captures(dev, algo, cfg.route_mode, grid and draw.sized,
                     tcfg is not None, grid, cfg.T, draw.block):
            key = (algo, pod, cluster, a_max, n_cells, draw.block, dev,
                   tuple((k, v.shape) for k, v in fixed.items()))
    return _slot_loop(draw, step, state, sums, fixed, cfg, key), tele


def _cell_draws(gen: torch.Generator, cluster: Cluster, rates: Rates,
                cfg: SimConfig, pod: Optional[PodSpec], a_max: int,
                lam: float, scen: ScenarioData, family: str) -> TorchDraws:
    """One cell's ``TorchDraws`` at arrival rate ``lam`` (tasks a slot at
    the scenario's mean) on the scenario's device."""
    dev = scen.base_speed.device
    lam_t = torch.tensor(lam, dtype=_F, device=dev) * scen.lam_shape
    return TorchDraws(gen, cluster, rates, cfg, pod, a_max, lam_t, family, scen)


def _run_cells(algo: str, cluster: Cluster, rates: Rates, cfg: SimConfig,
               pod: Optional[PodSpec], a_max: int, scen: ScenarioData,
               lam, n_seeds: int, seed0: int, homo: bool, tcfg=None):
    """Every cell (s, k, l) of ``lam`` [S][L] (arrival rates, Python
    floats) x ``n_seeds`` seeds in one slot loop, cell index (s * n_seeds
    + k) * L + l.  ``scen``: one ScenarioData (S = 1) or a stacked one of S
    rows.  Seed k draws from a generator seeded ``seed0 + k`` on the
    scenario's device.  Returns (RawSums, Telemetry or None), every leaf
    with a leading [S * n_seeds * L]."""
    dev = scen.base_speed.device
    family = _family(algo)

    def cells():
        rows = ([scenario_row(scen, s) for s in range(len(lam))]
                if scen.base_speed.ndim == 2 else [scen])
        sources, per_cell = [], []
        for row, lam_row in zip(rows, lam):
            for k in range(n_seeds):
                for l in lam_row:
                    gen = torch.Generator(device=dev).manual_seed(seed0 + k)
                    sources.append(_cell_draws(gen, cluster, rates, cfg, pod,
                                               a_max, float(l), row, family))
                    per_cell.append(row)
        size = None
        if any(src.sized for src in sources):
            col = lambda name: torch.stack(
                [getattr(r, name) for r in per_cell])[:, None]
            size = SizeLaw(col("size_mu"), col("size_sigma"))
        return GridDraws(sources), size

    return _run(cells, dev, algo=algo, cluster=cluster, rates=rates, cfg=cfg,
                pod=pod, a_max=a_max, n_cells=sum(map(len, lam)) * n_seeds,
                scen=scen, homo=homo, tcfg=tcfg)


def _grid_leaves(x, shape: tuple):
    """A tuple of [cells, ...] leaves (None kept) with the cell axis
    reshaped to the grid's ``shape``."""
    return type(x)(*(None if v is None else v.reshape(shape + v.shape[1:])
                     for v in x))


def _simulate(algo, cluster, rates, load, key, cfg, pod, scenario, pad,
              a_max, device, draws, tcfg):
    """``simulate`` and ``simulate_with_telemetry``: (SimResult, Telemetry
    of the one cell, or None)."""
    family = _family(algo)
    dev = resolve_device(device)
    with span("sim.grid.realize"):
        scen, lam_cap = realize(scenario, cluster, rates, cfg.T, pad,
                                device=dev)
        lam = float(load) * lam_cap
        pod = _pod_for(algo, pod)
        if a_max is None:
            a_max = cfg.resolve_a_max(lam, float(scen.lam_shape.max()))
        homo = _rates_homogeneous(scen)

    def cells():
        if draws is not None:
            return _CallerDraws(draws), scen
        gen = key if isinstance(key, torch.Generator) else \
            torch.Generator(device=dev).manual_seed(int(key))
        return GridDraws([_cell_draws(gen, cluster, rates, cfg, pod, a_max,
                                      lam, scen, family)]), scen

    sums, tele = _run(cells, dev, algo=algo, cluster=cluster, rates=rates,
                      cfg=cfg, pod=pod, a_max=a_max, n_cells=1, scen=scen,
                      homo=homo, tcfg=tcfg)
    with span("sim.grid.summarize"):
        res = summarize(_drop(sums), algo, cluster, rates, pod)
    return res, None if tele is None else _drop(tele)


def simulate(algo: str, cluster: Cluster, rates: Rates, load: float,
             key, cfg: SimConfig = SimConfig(),
             pod: Optional[PodSpec] = None, scenario=None, pad=None,
             a_max: Optional[int] = None, *, device=None,
             draws: Optional[DrawSource] = None) -> SimResult:
    """Run one simulation and return derived metrics: a grid of one cell.

    load: fraction of the scenario's capacity edge (lambda = load * M *
    alpha on the uniform scenario).  key: an int seed or a
    ``torch.Generator`` on ``device``.  scenario: a registered name, a
    ``scenarios.Scenario`` or None (``uniform``).  pad / a_max: the
    canonical sweep controls (``scenarios.canonical_pad`` /
    ``canonical_a_max``); a_max None sizes the arrival buffer from the
    scenario's peak intensity.  device: None runs on the CUDA card (and
    raises without one); pass "cpu" to run on the CPU.  draws: a draw
    source replacing the default ``TorchDraws``: a callable from slot index
    to the family's draws (``SlotDraws``, ``SQDraws`` or ``FCFSDraws``) of
    the one cell, unbatched."""
    return _simulate(algo, cluster, rates, load, key, cfg, pod, scenario, pad,
                     a_max, device, draws, None)[0]


def simulate_with_telemetry(
        algo: str, cluster: Cluster, rates: Rates, load: float, key,
        cfg: SimConfig = SimConfig(), pod: Optional[PodSpec] = None,
        scenario=None, pad=None, a_max: Optional[int] = None,
        telemetry: tlm.TelemetryConfig = tlm.TelemetryConfig(), *,
        device=None, draws: Optional[DrawSource] = None):
    """``simulate`` plus the collectors; returns (SimResult, Telemetry).

    The SimResult is ``simulate``'s bit for bit (the collectors take no
    draw).  The Telemetry's tensors lie on the run's device;
    ``repro_torch.telemetry.export`` reads them (JSONL events, windowed
    drift, sojourn percentiles, probe summaries).  Arguments as in
    ``simulate``."""
    return _simulate(algo, cluster, rates, load, key, cfg, pod, scenario, pad,
                     a_max, device, draws, telemetry)


def simulate_auto_warmup(
        algo: str, cluster: Cluster, rates: Rates, load: float, key,
        cfg: SimConfig = SimConfig(), pod: Optional[PodSpec] = None,
        scenario=None, pad=None, a_max: Optional[int] = None,
        telemetry: tlm.TelemetryConfig = tlm.TelemetryConfig(),
        policy: Optional[WarmupPolicy] = None, *, device=None):
    """``simulate_with_telemetry`` plus the drift-aware auto-extend warmup.

    Runs once at ``cfg.T``; then ``telemetry.export.auto_extend_warmup``
    moves the measurement boundary forward window by window while the
    windowed drift of the remaining tail is at least ``policy.threshold``
    (or until its guards stop it).  Window sums are per-slot sums, so the
    tail's statistics are those of a run measured with the later warmup;
    nothing runs again.  Returns (SimResult, Telemetry, WarmupReport); the
    SimResult is the run's own (configured warmup), ``simulate``'s bit for
    bit.  A NaN drift is reported as not converged."""
    res, tele = simulate_with_telemetry(
        algo, cluster, rates, load, key, cfg=cfg, pod=pod, scenario=scenario,
        pad=pad, a_max=a_max, telemetry=telemetry, device=device)
    report = auto_extend_warmup(tele, telemetry, cfg.T, cfg.warmup,
                                policy=WarmupPolicy() if policy is None else policy)
    return res, tele, report


def _grid(algo, cluster, rates, loads, n_seeds, cfg, pod, seed0, scenario,
          pad, a_max, device, tcfg):
    """``simulate_grid`` and ``simulate_grid_with_telemetry``: (SimResult,
    Telemetry or None), every leaf leading by [n_seeds, n_loads]."""
    dev = resolve_device(device)
    with span("sim.grid.realize"):
        scen, lam_cap = realize(scenario, cluster, rates, cfg.T, pad,
                                device=dev)
        lam = [float(l) * lam_cap for l in loads]
        pod = _pod_for(algo, pod)
        if a_max is None:
            a_max = cfg.resolve_a_max(
                float(np.max(np.asarray(lam, np.float32))),
                float(scen.lam_shape.max()))
        homo = _rates_homogeneous(scen)
    sums, tele = _run_cells(algo, cluster, rates, cfg, pod, a_max, scen, [lam],
                            n_seeds, seed0, homo=homo, tcfg=tcfg)
    shape = (n_seeds, len(lam))
    with span("sim.grid.summarize"):
        res = summarize(_grid_leaves(sums, shape), algo, cluster, rates, pod)
        tele = None if tele is None else _grid_leaves(tele, shape)
    return res, tele


def simulate_grid(algo: str, cluster: Cluster, rates: Rates, loads,
                  n_seeds: int, cfg: SimConfig = SimConfig(),
                  pod: Optional[PodSpec] = None, seed0: int = 0,
                  scenario=None, pad=None, a_max: Optional[int] = None, *,
                  device=None) -> SimResult:
    """Loads x seeds of one scenario in one slot loop: n_seeds x len(loads)
    cells, every slot one ``route_commit`` launch for all of them.
    Returns a SimResult whose leaves lead by [n_seeds, n_loads].  Cell (k,
    l) draws from a generator seeded ``seed0 + k`` and equals
    ``simulate(algo, ..., loads[l], seed0 + k, ..., a_max=<this grid's>)``
    bit for bit.  pad / a_max as in ``simulate`` (a_max None: sized from
    the largest load); device as in ``simulate``."""
    return _grid(algo, cluster, rates, loads, n_seeds, cfg, pod, seed0,
                 scenario, pad, a_max, device, None)[0]


def simulate_grid_with_telemetry(
        algo: str, cluster: Cluster, rates: Rates, loads, n_seeds: int,
        cfg: SimConfig = SimConfig(), pod: Optional[PodSpec] = None,
        seed0: int = 0, scenario=None, pad=None, a_max: Optional[int] = None,
        telemetry: tlm.TelemetryConfig = tlm.TelemetryConfig(), *,
        device=None):
    """``simulate_grid`` plus the collectors; returns (SimResult,
    Telemetry), every leaf leading by [n_seeds, n_loads].  Each cell's
    Telemetry equals that of the looped ``simulate_with_telemetry`` run
    with the grid's a_max.  Reduce with ``telemetry.export.aggregate``, or
    index one cell (``cell_view``) for its windows."""
    return _grid(algo, cluster, rates, loads, n_seeds, cfg, pod, seed0,
                 scenario, pad, a_max, device, telemetry)


def sweep_grid(cluster: Cluster, rates: Rates, cfg: SimConfig, loads,
               scenarios=None, pad=None, a_max: Optional[int] = None, *,
               device=None):
    """The grid ``simulate_sweep`` runs: realizes and stacks the scenarios
    (``scenarios.stack_scenarios``) and resolves the grid's shared
    arrival-buffer width.  Returns ``(names, stacked ScenarioData with
    leading [S], lam [S, L] float32 absolute arrival rates, a_max)``.
    ``scenarios``: registered names and/or Scenario objects (default: the
    whole registry); ``a_max`` defaults to the largest ``resolve_a_max``
    over the (scenario, load) cells, each sized from its scenario's peak
    slot intensity.  device as in ``simulate``."""
    dev = resolve_device(device)
    names = list(scenarios) if scenarios is not None else list(scenario_names())
    stacked, caps = stack_scenarios(names, cluster, rates, cfg.T, pad,
                                    device=dev)
    loads = [float(l) for l in loads]
    lam = caps[:, None] * np.asarray(loads)[None, :]
    if a_max is None:
        peaks = host(stacked.lam_shape).max(axis=1)
        a_max = max(cfg.resolve_a_max(float(c) * max(loads), float(p))
                    for c, p in zip(caps, peaks))
    labels = [getattr(n, "name", n) for n in names]
    return labels, stacked, torch.tensor(lam, dtype=_F, device=dev), int(a_max)


def simulate_sweep(algo: str, cluster: Cluster, rates: Rates, loads,
                   n_seeds: int, cfg: SimConfig = SimConfig(),
                   pod: Optional[PodSpec] = None, seed0: int = 0,
                   scenarios=None, pad=None, a_max: Optional[int] = None,
                   telemetry: Optional[tlm.TelemetryConfig] = None,
                   devices=None, *, device=None):
    """Scenarios x seeds x loads in one slot loop (``sweep_grid``): every
    slot one ``route_commit`` launch for all S * n_seeds * L cells, each
    cell on its scenario's [M, 3] rates (the sweep never takes the
    homogeneous path, as in the reference).

    Seed k of every (scenario, load) cell draws from a generator seeded
    ``seed0 + k``, as ``simulate_grid`` does, so every cell equals the
    looped ``simulate_grid(algo, ..., scenario=name, pad=pad,
    a_max=<this sweep's>)`` cell bit for bit, telemetry included.
    ``devices``: torch devices to split the scenario axis over, in
    contiguous chunks run one after another and joined in order (default:
    ``device``, as in ``simulate``).  ``telemetry``: a TelemetryConfig to
    collect, or None.

    Returns ``(names, SimResult, Telemetry or None)``, every leaf leading
    by [n_scenarios, n_seeds, n_loads]: reduce per cell
    (``telemetry.export.cell_view``), never across scenarios."""
    if telemetry is not None and not isinstance(telemetry, tlm.TelemetryConfig):
        raise TypeError(f"telemetry must be a TelemetryConfig or None, not "
                        f"{type(telemetry).__name__}")
    devs = [resolve_device(d) for d in devices] if devices is not None \
        else [resolve_device(device)]
    with span("sim.grid.realize"):
        names, stacked, lam, a_max = sweep_grid(cluster, rates, cfg, loads,
                                                scenarios, pad, a_max,
                                                device=devs[0])
        pod = _pod_for(algo, pod)
        lam = lam.tolist()
    S = len(lam)
    parts = []
    for d, idx in zip(devs, np.array_split(np.arange(S), min(len(devs), S))):
        lo, hi = int(idx[0]), int(idx[-1]) + 1
        chunk = ScenarioData(*(None if x is None else x[lo:hi].to(d)
                               for x in stacked))
        sums, tele = _run_cells(algo, cluster, rates, cfg, pod, a_max, chunk,
                                lam[lo:hi], n_seeds, seed0, homo=False,
                                tcfg=telemetry)
        parts.append((sums, tele))
    shape = (S, n_seeds, len(lam[0]))
    join = lambda xs: None if xs[0] is None else \
        torch.cat([x.to(devs[0]) for x in xs]).reshape(shape + xs[0].shape[1:])
    with span("sim.grid.summarize"):
        sums = RawSums(*map(join, zip(*(p[0] for p in parts))))
        tele = None
        if telemetry is not None:
            tele = tlm.Telemetry(*map(join, zip(*(p[1] for p in parts))))
        res = summarize(sums, algo, cluster, rates, pod)
    return names, res, tele


def summarize(s: RawSums, algo: str, cluster: Cluster, rates: Rates,
              pod: Optional[PodSpec]) -> SimResult:
    """Reduce raw sums to a ``SimResult`` (Little's-law mean delay,
    locality fractions, drift, clip fraction, probe complexity)."""
    family = _family(algo)
    slots = torch.clamp_min(s.slots, 1.0)
    mean_N = s.sum_N / slots
    lam_hat = s.arrivals / slots
    mean_T = mean_N / torch.clamp_min(lam_hat, 1e-9)
    h = torch.clamp_min(slots / 2.0, 1.0)
    starts_total = torch.clamp_min(s.starts.sum(-1, keepdim=True), 1.0)
    routed_total = torch.clamp_min(s.routed.sum(-1, keepdim=True), 1.0)
    if family == "bp":
        route_cand = bp_candidates_per_route(cluster, pod)
        sched_cand = 1  # own sub-queues only — purely local information
    elif algo in ("jsq_maxweight", "jsq_maxweight_pod"):
        route_cand = cluster.n_replicas
        sched_cand = jsqmw_candidates_per_schedule(cluster, pod)
    elif algo == "jsq_priority":
        route_cand = cluster.n_replicas
        sched_cand = cluster.M
    else:  # fcfs
        route_cand = 0
        sched_cand = 1
    f = lambda x: torch.tensor(float(x), dtype=_F, device=slots.device)
    return SimResult(
        mean_tasks_in_system=mean_N,
        mean_completion_slots=mean_T,
        mean_completion_norm=mean_T * rates.alpha,
        arrival_rate_hat=lam_hat,
        throughput=s.completions / slots,
        utilization=s.busy / (slots * cluster.M),
        locality_fractions=s.starts / starts_total,
        routed_fractions=s.routed / routed_total,
        drift=torch.where(s.sum_N_h1 > 0,
                          (s.sum_N_h2 / h) / torch.clamp_min(s.sum_N_h1 / h,
                                                             1e-30),
                          float("nan")),
        clip_fraction=s.clipped / torch.clamp_min(s.arrivals + s.clipped, 1.0),
        route_decisions=s.route_decisions,
        sched_decisions=s.sched_decisions,
        route_candidates_per_decision=f(route_cand),
        sched_candidates_per_decision=f(sched_cand),
    )
