"""Telemetry collectors: state updated by the slot loop (mirror of
``repro.telemetry.collectors``).

Two contracts, as in the reference:

  1. No dynamics perturbation.  Collectors take no random draws and feed
     nothing back into routing or scheduling: a run with telemetry is
     bit-identical (same RawSums) to one without.
  2. No host read.  A collector reads no tensor value on the host; the
     window of slot t is ``t // window_len`` from the loop's own Python t.

Every leaf leads by the cell axis [N] of the batched simulator state (one
row a grid cell); the slot steps also take one cell's unbatched state and
lift it, telemetry included.  The collectors update the tensors of a
``Telemetry`` in place and return it.

State layout (``Telemetry``, per cell):

  win        [W, n sum channels]  per-window accumulators (WINDOW_SUMS;
             slot t adds into window w = t // window_len, window_len =
             ceil(T / W))
  win_max    [W, n max channels]  per-window running maxima (WINDOW_MAXES)
  qlen_hist  [W, B]  per-window histogram of per-server queue lengths
  work_hist  [W, B]  per-window histogram of per-server workloads
  sojourn_hist [B]   per-task sojourn histogram, tasks that arrived at or
             after warmup only
  sojourn_dropped    count of tasks whose arrival slot a full ring could not
             record (the record is dropped, never the task)
  ring/head/tail/cur_arr   the FIFO rings of arrival slots behind the
             sojourn histogram (BP: one per (server, class) sub-queue; SQ:
             one per server; FCFS: none).  ``cur_arr[m]`` is the arrival
             slot of server m's task in service (-1 = unknown).  Row NQ of
             a ring is a dummy that absorbs dropped and masked records and
             is never read.

Probe quality (pod policies): per decision, the rank of the chosen
server's score among all M (0 = the probe set held the optimum) and the
regret (chosen score minus the optimum).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from .hist import BINS_PER_OCTAVE, N_BINS, bin_index

_F = torch.float32


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Collector parameters (hashable), the reference's fields and
    defaults."""

    n_windows: int = 64          # W: windowed-time-series resolution
    n_bins: int = N_BINS         # B: histogram bins (hist.py convention)
    bins_per_octave: int = BINS_PER_OCTAVE
    sojourns: bool = True        # per-task sojourn histogram (BP/SQ)
    probes: bool = True          # pod probe rank/regret channels
    ring_cap: int = 128          # FIFO arrival-slot records per queue

    def window_len(self, T: int) -> int:
        """Slots per window: ceil(T / n_windows); last window ragged."""
        return max(1, -(-T // self.n_windows))


# Per-window SUM channels; "slots" counts slots so means are sums / slots
WINDOW_SUMS = (
    "slots", "sum_N", "q_local", "q_rack", "q_remote", "completions",
    "busy", "arrivals", "clipped", "w_mean", "w_max",
    "probe_rank", "probe_regret", "probe_decisions",
)
# Per-window MAX channels
WINDOW_MAXES = ("max_N", "max_w")


class Telemetry(NamedTuple):
    """Collector state carried through the slot loop (see module doc)."""

    win: torch.Tensor
    win_max: torch.Tensor
    qlen_hist: torch.Tensor
    work_hist: torch.Tensor
    sojourn_hist: torch.Tensor
    sojourn_dropped: torch.Tensor
    ring: Optional[torch.Tensor] = None      # [NQ + 1, cap] int32 (dummy row)
    head: Optional[torch.Tensor] = None      # [NQ + 1] int32
    tail: Optional[torch.Tensor] = None      # [NQ + 1] int32
    cur_arr: Optional[torch.Tensor] = None   # [M] int32, -1 = unknown


def zero_telemetry(tcfg: TelemetryConfig, M: int, family: str, *,
                   device="cpu", cells: Optional[int] = None) -> Telemetry:
    """Fresh collector state, with a leading [cells] axis if given.

    family: "bp" (per-(server, class) sub-queues), "sq" (one queue per
    server) or "fcfs" (central queue: no sojourn rings, the grabbed task's
    identity is sampled at dequeue)."""
    lead = () if cells is None else (cells,)
    W, B = tcfg.n_windows, tcfg.n_bins
    z = lambda *s, dtype=_F: torch.zeros(lead + s, dtype=dtype, device=device)
    ring = head = tail = cur_arr = None
    if tcfg.sojourns and family in ("bp", "sq"):
        nq = 3 * M if family == "bp" else M
        ring = torch.full(lead + (nq + 1, tcfg.ring_cap), -1, dtype=torch.int32,
                          device=device)
        head = z(nq + 1, dtype=torch.int32)
        tail = z(nq + 1, dtype=torch.int32)
        cur_arr = torch.full(lead + (M,), -1, dtype=torch.int32, device=device)
    return Telemetry(win=z(W, len(WINDOW_SUMS)), win_max=z(W, len(WINDOW_MAXES)),
                     qlen_hist=z(W, B), work_hist=z(W, B), sojourn_hist=z(B),
                     sojourn_dropped=z(), ring=ring, head=head, tail=tail,
                     cur_arr=cur_arr)


# ---------------------------------------------------------------------------
# Windowed time series + per-window distributions
# ---------------------------------------------------------------------------


def collect_step(tele: Telemetry, tcfg: TelemetryConfig, *, t: int, T: int,
                 N, q_mass, qlen, workload, arrivals, clipped, completions,
                 busy_n, probe) -> Telemetry:
    """Fold one slot's observables of every cell into the windows.

    t: the slot (a Python int); N, arrivals, clipped, completions, busy_n:
    [cells]; q_mass: [cells, 3] queue mass by locality class; qlen:
    [cells, M] (FCFS: [cells, 1]) per-server queue lengths; workload:
    [cells, M] per-server workload, or None (a family without one); probe:
    (rank_sum, regret_sum, n_decisions), each [cells] or 0.0."""
    w = min(t // tcfg.window_len(T), tcfg.n_windows - 1)
    f = lambda x: x.to(_F) if torch.is_tensor(x) else torch.full_like(N, x)
    if workload is None:
        w_mean = w_max = torch.zeros_like(N)
    else:
        finite = torch.where(torch.isfinite(workload), workload, 0.0)
        w_mean = finite.mean(dim=-1)
        w_max = finite.amax(dim=-1)
    q_mass = q_mass.to(_F)
    rank_s, regret_s, probe_n = probe
    row = torch.stack([
        torch.ones_like(N), f(N), q_mass[..., 0], q_mass[..., 1], q_mass[..., 2],
        f(completions), f(busy_n), f(arrivals), f(clipped), w_mean, w_max,
        f(rank_s), f(regret_s), f(probe_n)], dim=-1)
    tele.win[:, w] += row
    torch.maximum(tele.win_max[:, w], torch.stack([f(N), w_max], dim=-1),
                  out=tele.win_max[:, w])
    bins = lambda v: bin_index(v, tcfg.n_bins, tcfg.bins_per_octave)
    _hist_add(tele.qlen_hist[:, w], bins(qlen))
    if workload is not None:
        _hist_add(tele.work_hist[:, w], bins(finite))
    return tele


def _hist_add(hist: torch.Tensor, b: torch.Tensor,
              weight: Optional[torch.Tensor] = None) -> None:
    """Add ``weight`` (default 1) at bins ``b`` [cells, k] of ``hist``
    [cells, B], in place, accumulating repeated bins."""
    hist.scatter_add_(-1, b, torch.ones(b.shape, dtype=_F, device=b.device)
                      if weight is None else weight.to(_F))


# ---------------------------------------------------------------------------
# Sojourn rings: per-queue FIFOs of arrival slots mirrored on the queue
# counts.  Push at routing, pop at service start, record at completion.
# ---------------------------------------------------------------------------


def _before_same(qid: torch.Tensor, on: torch.Tensor) -> torch.Tensor:
    """[cells, P] count of earlier entries j < i with on[j] and the same
    qid: each entry's rank among the entries of its queue."""
    P = qid.shape[-1]
    i = torch.arange(P, device=qid.device)
    same = ((qid[..., None, :] == qid[..., :, None]) & on[..., None, :]
            & (i[None, :] < i[:, None]))
    return same.sum(dim=-1)


def ring_push(tele: Telemetry, tcfg: TelemetryConfig, qid: torch.Tensor,
              mask: torch.Tensor, t: int) -> Telemetry:
    """Append arrival slot ``t`` to the FIFO of queue ``qid[n, a]`` for every
    valid arrival (``mask`` [cells, A]).  Same-queue arrivals of a batch
    take successive ring slots in batch order.  A full ring drops the
    record (counted); the queue itself is not affected."""
    if tele.ring is None:
        return tele
    cap = tcfg.ring_cap
    nq = tele.ring.shape[-2] - 1
    qid = qid.to(torch.int64)
    rank = _before_same(qid, mask)
    tail_q = tele.tail.gather(-1, qid)
    ok = mask & (tail_q - tele.head.gather(-1, qid) + rank < cap)
    qd = torch.where(ok, qid, nq)                       # dummy row absorbs
    pos = torch.where(ok, (tail_q + rank) % cap, 0)
    cells = torch.arange(qid.shape[0], device=qid.device)[:, None].expand_as(qid)
    # every write to the dummy row stores the same t, so repeats are benign
    tele.ring.index_put_((cells, qd, pos),
                         torch.full(qid.shape, t, dtype=torch.int32,
                                    device=qid.device))
    tele.tail.scatter_add_(-1, qd, torch.ones_like(qd, dtype=torch.int32))
    tele.tail[:, nq] = 0                                # keep dummy row inert
    tele.sojourn_dropped.add_((mask & ~ok).sum(dim=-1).to(_F))
    return tele


def ring_pop(tele: Telemetry, tcfg: TelemetryConfig, qid: torch.Tensor,
             do_pop: torch.Tensor, server: torch.Tensor,
             distinct: bool = False) -> Telemetry:
    """Pop the head arrival slot of queue ``qid[n, s]`` for every granted
    service start (``do_pop`` [cells, P]) and stamp it into
    ``cur_arr[n, server[n, s]]``.  Claimants of one queue (SQ steal
    conflicts) are ranked by position; ``distinct`` says the queues of a
    row are distinct (BP: server m pops only its own sub-queues), where
    every rank is 0 and the pairwise compare is skipped.  A queue with no
    records (after an overflow) yields -1: that task's sojourn is skipped,
    never recorded as 0."""
    if tele.ring is None:
        return tele
    cap = tcfg.ring_cap
    nq = tele.ring.shape[-2] - 1
    qid = qid.to(torch.int64)
    server = server.to(torch.int64)
    head_q = tele.head.gather(-1, qid)
    nrec = tele.tail.gather(-1, qid) - head_q
    if distinct:
        rank = torch.zeros_like(qid)
    else:
        rank = _before_same(qid, do_pop)
    ok = do_pop & (rank < nrec)
    pos = (head_q + rank) % cap
    arr = tele.ring.flatten(-2).gather(-1, qid * cap + pos)
    arr = torch.where(ok, arr, -1)
    qd = torch.where(ok, qid, nq)
    tele.head.scatter_add_(-1, qd, torch.ones_like(qd, dtype=torch.int32))
    tele.head[:, nq] = 0
    cur = tele.cur_arr.gather(-1, server)
    tele.cur_arr.scatter_(-1, server, torch.where(do_pop, arr, cur))
    return tele


def record_sojourns(tele: Telemetry, tcfg: TelemetryConfig, t: int,
                    warmup: int, completed: torch.Tensor) -> Telemetry:
    """At completion (``completed`` [cells, M]), sojourn = t - arrival slot
    of the task in service, recorded only when that task arrived at or
    after warmup (refsim's measurement condition)."""
    if tele.cur_arr is None:
        return tele
    s = t - tele.cur_arr
    valid = completed & (tele.cur_arr >= warmup)
    _hist_add(tele.sojourn_hist, bin_index(s, tcfg.n_bins, tcfg.bins_per_octave),
              valid)
    return tele


# ---------------------------------------------------------------------------
# Probe quality (rank / regret of pod decisions against the O(M) optimum)
# ---------------------------------------------------------------------------


def _probe_sums(rank, regret, valid):
    """Per-cell (rank_sum, regret_sum, n) over every axis after the first."""
    regret = torch.where(torch.isfinite(regret), regret, 0.0)
    v = valid.to(_F)
    s = lambda x: (x * v).flatten(1).sum(dim=-1)
    return s(rank.to(_F)), s(torch.clamp_min(regret, 0.0)), v.flatten(1).sum(dim=-1)


def probe_stats_min(full_scores: torch.Tensor, chosen: torch.Tensor,
                    valid: torch.Tensor):
    """(rank_sum, regret_sum, n), each [cells], for arg-MIN decisions.

    full_scores: [cells, ..., M] score of every server the O(M) policy
    would examine (+inf = ineligible); chosen: [cells, ...] the decision's
    own score; valid: [cells, ...].  rank = count of strictly better
    servers; regret = chosen - min."""
    best = full_scores.amin(dim=-1)
    rank = (full_scores < chosen[..., None]).sum(dim=-1)
    return _probe_sums(rank, chosen - best, valid)


def probe_stats_max(full_scores: torch.Tensor, chosen: torch.Tensor,
                    valid: torch.Tensor, eligible: torch.Tensor):
    """(rank_sum, regret_sum, n), each [cells], for arg-MAX decisions
    (JSQ-MaxWeight scheduling); eligible masks the (server, queue) pairs
    the O(M) policy may pick; regret = max - chosen."""
    best = torch.where(eligible, full_scores, -float("inf")).amax(dim=-1)
    rank = (eligible & (full_scores > chosen[..., None])).sum(dim=-1)
    return _probe_sums(rank, best - chosen, valid)


ZERO_PROBE = (0.0, 0.0, 0.0)
