"""Plain PyTorch reference of a scenario sweep: the paper's slotted model
(arXiv:1904.00447 §III-IV) on heterogeneous servers whose speeds change over
time, written from the scenario semantics, for the comparison that decides a
``sweep`` cell's ``correct``.

It imports torch and numpy and, of the benchmark, ``portbench.reference``'s
draw and slot helpers; nothing of the program.  Its input is the scenarios'
declarative specs: any objects with the registry's fields (a fleet's rack
speeds, slow cohorts and event windows; a traffic shape or a product of
shapes; the placement; the size law; the realization seed).  It realizes
them itself (``realize``), with a frozen numpy copy of the realization: the
fleet arrays, the windows' servers and slots, the intensity shapes with the
MMPP chain, the pad and the closed-form capacity edge.

Semantics beyond ``reference.py``'s, per cell and slot:

  speeds      a busy server completes ``speed[m, cls]`` work a slot, where
              ``speed`` is the base speed times the product of the active
              windows' multipliers, folded left to right ((m0 * m1) * m2) ...
              and then multiplied by the base speed;
  dead tiers  a tier at speed 0 starts nothing of its class, and a server
              with every tier at 0 schedules nothing (a busy one stalls);
  routing     BP-Pod's workloads and scores divide by the cell's own [M, 3]
              rates of the slot (speed x (alpha, beta, gamma)): a dead tier's
              inverse rate is +inf, adds no workload, and scores +inf;
  arrivals    Poisson at ``lam x lam_shape[t]`` (lam in float32);
  draws       those of ``TorchDraws`` with a padded catalog: the Poisson
              counts, the catalog's float64 chunk uniform (whose outcome the
              uniform placement flag discards), the uniform triple, the
              durations and the candidate sets.

``fdt`` is the floating type of the slot state and its arithmetic, as in
``reference.run``: bfloat16 is the control the comparison has to fail.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from portbench import reference as ref

_F = torch.float32


class Realized(NamedTuple):
    """One scenario's arrays, its windows padded to the sweep's count."""

    lam_shape: np.ndarray     # [T] float32 intensity shape, mean ~1
    base_speed: np.ndarray    # [M] float32
    win_start: np.ndarray     # [E] int32 (pads: start == end == 0)
    win_end: np.ndarray       # [E] int32
    win_mult: np.ndarray      # [E, M, 3] float32 (pads: 1.0)
    lam_cap: float            # capacity edge, tasks a slot at load 1


class Sweep(NamedTuple):
    """What one sweep call simulates: the configuration and its cells."""

    algo: str                 # balanced_pandas_pod
    M: int
    K: int
    rates: tuple              # (alpha, beta, gamma)
    pod: tuple                # (d_rack, d_remote)
    T: int
    warmup: int
    a_max: int
    s_max: int
    scens: list               # Realized of each scenario
    lams: list                # float32 arrival rate of each cell
    seeds: list               # generator seed of each cell
    rows: list                # scenario of each cell


# ---------------------------------------------------------------------------
# Realization: a frozen copy, in numpy, on the host
# ---------------------------------------------------------------------------

def _class_mult(mult) -> tuple:
    """A window's (local, rack, remote) multipliers: a scalar scales all."""
    if isinstance(mult, (int, float)):
        return (float(mult),) * 3
    m = tuple(float(x) for x in mult)
    if len(m) != 3:
        raise ValueError(f"a per-class multiplier needs 3 entries, got {mult}")
    return m


def _servers(w, M: int, K: int) -> np.ndarray:
    """bool [M]: the servers a window selects (a rack, an id interval, every
    f-th server from a phase, or one rack member taken modulo the rack)."""
    m, R = np.arange(M), M // K

    def rack(r):
        if not 0 <= r < K:
            raise ValueError(f"window {w} targets rack {r} of {K}")
        return r
    if w.rack is not None:
        return m // R == rack(w.rack)
    if w.servers is not None:
        lo, hi = w.servers
        return (m >= lo) & (m < hi)
    if w.every is not None:
        return m % w.every == w.phase
    if w.rack_member is not None:
        r, i = w.rack_member
        return m == rack(r) * R + i % R
    raise ValueError(f"window {w} selects no servers")


def _fleet(fleet, M: int, K: int, T: int, rng: np.random.Generator):
    R = M // K
    base = np.ones(M, np.float32)
    for r, s in enumerate(fleet.rack_speeds):
        base[r * R:(r + 1) * R] = s
    head = (((fleet.slow_frac, fleet.slow_mult),)
            if fleet.slow_frac > 0.0 and fleet.slow_mult != 1.0 else ())
    for frac, mult in head + tuple(fleet.slow):
        base[rng.choice(M, size=max(1, int(round(frac * M))), replace=False)] *= mult
    E = len(fleet.windows)
    start, end = np.zeros(E, np.int32), np.zeros(E, np.int32)
    mult = np.ones((E, M, 3), np.float32)
    for e, w in enumerate(fleet.windows):
        start[e], end[e] = int(round(w.t0 * T)), int(round(w.t1 * T))
        mult[e, _servers(w, M, K)] = np.asarray(_class_mult(w.mult), np.float32)
    return base, start, end, mult


def _shape_one(part, T: int, rng: np.random.Generator) -> np.ndarray:
    """[T] float64 intensity of one factor, clamped at 0."""
    t = np.arange(T, dtype=np.float64)
    if part.kind == "stationary":
        shape = np.ones(T)
    elif part.kind == "diurnal":
        shape = 1.0 + part.amp * np.sin(2.0 * math.pi * part.cycles * t / T)
    elif part.kind == "flash":
        shape = np.ones(T)
        shape[int(part.t0 * T):int(part.t1 * T)] = part.peak
    elif part.kind == "mmpp":
        # a quiet/burst chain from its stationary law, stepped after each slot
        p01, p10 = part.p_enter, part.p_exit
        state = 1 if rng.random() < p01 / max(p01 + p10, 1e-12) else 0
        shape, u = np.empty(T), rng.random(T)
        for i in range(T):
            shape[i] = part.burst if state else 1.0
            if state == 0 and u[i] < p01:
                state = 1
            elif state == 1 and u[i] < p10:
                state = 0
    else:
        raise ValueError(f"the reference has no traffic kind {part.kind!r}")
    return np.maximum(shape, 0.0)


def _traffic(traffic, T: int, rng: np.random.Generator) -> np.ndarray:
    """[T] float32: the factors' product over the run, normalized to mean 1."""
    shape = np.ones(T, np.float64)
    for part in tuple(getattr(traffic, "factors", (traffic,))):
        shape = shape * _shape_one(part, T, rng)
    return (shape / max(shape.mean(), 1e-12)).astype(np.float32)


def capacity_scale(base, start, end, mult, T: int) -> float:
    """The time average of sum_m local speed / M: the speeds are piecewise
    constant between window edges, so integrate segment by segment."""
    edges = np.unique(np.clip(np.concatenate([[0, T], start, end]), 0, T)).astype(np.int64)
    local = mult.astype(np.float64)[:, :, 0]
    total = 0.0
    for lo, hi in zip(edges[:-1], edges[1:]):
        if hi <= lo:
            continue
        active = (start <= lo) & (lo < end)
        seg = base.astype(np.float64) * np.where(active[:, None], local, 1.0).prod(axis=0)
        total += float(seg.sum()) * (hi - lo)
    return total / (T * base.shape[0])


def realize(specs, M: int, K: int, rates, T: int, n_windows: int) -> list:
    """The ``Realized`` arrays of each scenario spec at T slots, its windows
    padded to ``n_windows``; the capacity edge is the closed form
    ``alpha x M x capacity_scale`` of uniform placement."""
    out = []
    for s in specs:
        if (s.placement.kind != "uniform" or hasattr(s.placement, "realize_catalog")
                or s.sizes.sigma != 0.0 or hasattr(s.traffic, "realize_shape")):
            raise ValueError(f"scenario {s.name!r}: the reference places uniformly, "
                             "with unit task sizes and formula traffic")
        rng = np.random.default_rng(s.seed)
        base, start, end, mult = _fleet(s.fleet, M, K, T, rng)
        shape = _traffic(s.traffic, T, rng)
        E = start.shape[0]
        if E > n_windows:
            raise ValueError(f"scenario {s.name!r} has {E} windows, the pad {n_windows}")
        start, end = np.pad(start, (0, n_windows - E)), np.pad(end, (0, n_windows - E))
        mult = np.pad(mult, ((0, n_windows - E), (0, 0), (0, 0)), constant_values=1.0)
        cap = rates[0] * M * capacity_scale(base, start, end, mult, T)
        out.append(Realized(shape, base, start, end, mult, cap))
    return out


def a_max_for(scens: list, loads) -> int:
    """The sweep's arrival-buffer width: the largest over its scenarios of
    peak + 6 sqrt(peak) + 4 rounded up, the peak being the largest load's
    rate at the scenario's highest intensity (the simulator's default)."""
    widths = []
    for sc in scens:
        peak = sc.lam_cap * max(float(l) for l in loads) * float(sc.lam_shape.max())
        widths.append(int(math.ceil(peak + 6.0 * math.sqrt(peak) + 4)))
    return max(widths)


def cells(scens: list, loads, seeds: list) -> tuple:
    """(lams, seeds, rows) of every cell, scenario by scenario, then seed by
    seed, then load by load: the program's cell order."""
    lams, cell_seeds, rows = [], [], []
    for r, sc in enumerate(scens):
        for s in seeds:
            for l in loads:
                lams.append(float(np.float32(sc.lam_cap * float(l))))
                cell_seeds.append(s)
                rows.append(r)
    return lams, cell_seeds, rows


# ---------------------------------------------------------------------------
# Draws
# ---------------------------------------------------------------------------

class CellDraws:
    """One cell's draws, a block of slots at a time, from its own generator,
    at the scenario's arrival intensity (``reference.CellDraws``'s, with a
    padded catalog's placement draw)."""

    def __init__(self, g: Sweep, sc: Realized, lam: float, seed: int, dev):
        self.g, self.dev = g, dev
        self.gen = torch.Generator(device=dev).manual_seed(int(seed))
        shape = torch.tensor(sc.lam_shape, dtype=_F, device=dev)
        self.lam_t = torch.tensor(lam, dtype=_F, device=dev) * shape
        self.p = torch.tensor(g.rates, dtype=_F, device=dev)
        self.block = ref.draw_block(g)

    def fill(self, t0: int) -> dict:
        g, gen, dev, M = self.g, self.gen, self.dev, self.g.M
        lam = self.lam_t[t0:t0 + self.block]
        n = lam.shape[0]
        out = {"raw": torch.poisson(lam, generator=gen).to(torch.int32)}
        # a padded catalog draws each task's chunk (a float64 uniform searched
        # in the chunk law) before its uniform triple; the placement flag of
        # uniform placement keeps the triple, so the chunk's outcome is unused
        torch.rand((n, g.a_max), generator=gen, dtype=torch.float64, device=dev)
        locals_ = ref._replicas(gen, M, n * g.a_max, dev).view(n, g.a_max, 3)
        out["locals"] = locals_
        out["dur"] = ref._durations(gen, self.p, n, M, dev)
        dr, dm = g.pod
        cls = ref.classes(locals_, M, M // g.K)
        idx, ok = ref._set_draws(gen, torch.stack([cls == ref.RACK, cls == ref.REMOTE]),
                                 max(dr, dm), dev)
        out["cand_idx"] = torch.cat([locals_, idx[0, ..., :dr], idx[1, ..., :dm]], dim=-1)
        out["cand_valid"] = torch.cat([torch.ones_like(locals_, dtype=torch.bool),
                                       ok[0, ..., :dr], ok[1, ..., :dm]], dim=-1)
        return out


class SweepDraws(ref.GridDraws):
    """Every cell's draws of slot t, stacked on a leading cell axis."""

    def __init__(self, g: Sweep, dev):
        self.cells = [CellDraws(g, g.scens[r], lam, s, dev)
                      for r, lam, s in zip(g.rows, g.lams, g.seeds)]
        self.block = self.cells[0].block
        self.t0, self.buf = None, None


def arrivals(g: Sweep, dev) -> torch.Tensor:
    """int32 [T, cells]: the arrivals each cell routes in each slot (its
    Poisson count clipped to ``a_max``), from the draws alone."""
    draws, out = SweepDraws(g, dev), []
    for t0 in range(0, g.T, draws.block):
        draws(t0)
        out.append(draws.buf["raw_host"])
    return torch.clamp_max(torch.cat(out)[:g.T], g.a_max)


# ---------------------------------------------------------------------------
# Speeds and rates
# ---------------------------------------------------------------------------

def _speed_table(g: Sweep, dev) -> tuple:
    """(speeds [G, M, 3], inverse rates [G, M, 3], segment [cells, T]): the
    speed of every stretch of slots between window edges of every scenario,
    and which stretch each cell is in at each slot."""
    speeds, seg = [], np.zeros((len(g.scens), g.T), np.int64)
    for r, sc in enumerate(g.scens):
        edges = np.unique(np.clip(np.concatenate([[0, g.T], sc.win_start, sc.win_end]), 0, g.T))
        for lo, hi in zip(edges[:-1], edges[1:]):
            prod = None
            for e in np.flatnonzero((sc.win_start <= lo) & (lo < sc.win_end)):
                prod = sc.win_mult[e] if prod is None else prod * sc.win_mult[e]
            one = np.ones((g.M, 3), np.float32)
            seg[r, lo:hi] = len(speeds)
            speeds.append(sc.base_speed[:, None] * (one if prod is None else prod))
    speed = torch.tensor(np.stack(speeds), dtype=_F, device=dev)
    rate = speed * torch.tensor(g.rates, dtype=_F, device=dev)
    inv = torch.where(rate > 0, 1.0 / torch.clamp_min(rate, 1e-12), math.inf)
    return speed, inv, torch.tensor(seg[g.rows], device=dev)


# ---------------------------------------------------------------------------
# The slot loop
# ---------------------------------------------------------------------------

def _slot(g: Sweep, st: ref.State, d: dict, speed, inv, fdt):
    N, M, dev = st.Q.shape[0], g.M, st.Q.device
    # busy servers do their class's speed of work; those at 0 complete
    work = speed.gather(2, st.cls[..., None])[..., 0]
    rem = torch.where(st.busy, st.rem - work, 0.0).to(st.rem.dtype)
    done = st.busy & (rem <= 0)
    st.busy = st.busy & ~done
    st.rem = torch.where(st.busy, rem, 0.0).to(st.rem.dtype)
    comp = done.sum(dim=-1).to(_F)
    # an idle server starts its own head task of a live tier: local, rack, remote
    has = (st.Q > 0) & (speed > 0)
    pick = torch.where(has[..., 0], 0, torch.where(has[..., 1], 1, 2))
    go = ~st.busy & has.any(dim=-1)
    st.Q = st.Q - ((pick[..., None] == torch.arange(3, device=dev)) & go[..., None]).to(torch.int32)
    m = torch.arange(M, device=dev).expand(N, M)
    ref._start(st, m, go, pick, d["dur"].gather(-1, pick[..., None])[..., 0].to(_F))
    starts, n_started = ref._by_class(pick, go), go.sum(dim=-1).to(_F)

    raw = d["raw"]
    n_arr = torch.clamp_max(raw, g.a_max)
    # workloads in the pinned order (q0/alpha + q1/beta) + q2/gamma, per server,
    # a dead tier adding nothing
    r = lambda x: x.to(fdt)
    up = torch.isfinite(inv)
    fin = torch.where(up, inv, 0.0)
    x = [r(st.Q[..., c].to(fdt) * fin[..., c]) for c in range(3)]
    W = r(r(x[0] + x[1]) + x[2])
    B = int(torch.clamp_max(d["raw_host"], g.a_max).max())
    act = torch.arange(B, device=dev) < n_arr[:, None]                       # [N, B]
    dW = torch.zeros_like(W)
    C = d["cand_idx"].shape[-1]
    ccls = torch.tensor([ref.LOCAL] * 3 + [ref.RACK] * g.pod[0] + [ref.REMOTE] * g.pod[1],
                        device=dev)
    valid = d["cand_valid"][:, :B]
    cand = d["cand_idx"][:, :B].long()                                       # [N, B, C]
    # a candidate scores against its own server's rate of its class: +inf on
    # a dead tier or an invalid candidate (an empty set drawn from)
    lane = (cand * 3 + ccls).flatten(1)
    fac = r(fin.flatten(1).gather(1, lane).view(cand.shape))
    live = valid & up.flatten(1).gather(1, lane).view(cand.shape)
    tie = ccls * C + torch.arange(C, device=dev) + (~valid).long() * 4 * C
    commit = r(fac * act[..., None])
    w0 = W.gather(1, cand.flatten(1)).view(cand.shape)
    picks, slots = [], []
    for b in range(B):
        c = cand[:, b]
        score = torch.where(live[:, b], r(r(w0[:, b] + dW.gather(1, c)) * fac[:, b]), math.inf)
        j = ref._lexmin(score, tie[:, b])[:, None]
        s = c.gather(1, j)
        dW.scatter_add_(1, s, commit[:, b].gather(1, j))
        picks.append(s[:, 0])
        slots.append(j[:, 0])
    if B:
        sel, scls = torch.stack(picks, 1), ccls[torch.stack(slots, 1)]
    else:
        sel = scls = torch.zeros((N, 0), dtype=torch.int64, device=dev)
    st.Q = st.Q.view(N, -1).scatter_add(1, sel * 3 + scls, act.to(torch.int32)).view(N, M, 3)
    busy_n = st.busy.sum(dim=-1).to(_F)
    arr = n_arr.to(_F)
    return dict(N=st.Q.sum(dim=(-2, -1)).to(_F) + busy_n, arrivals=arr,
                clipped=(raw - n_arr).to(_F), completions=comp, starts=starts,
                routed=ref._by_class(scls, act), busy=busy_n, route_decisions=arr,
                sched_decisions=n_started)


def run(g: Sweep, dev, fdt=_F) -> dict:
    """Simulate every cell of ``g``; returns each summary field, [cells, ...]."""
    if g.algo != "balanced_pandas_pod" or not g.pod:
        raise ValueError(f"the reference has no {g.algo!r} sweep")
    if 3 * g.M >= 1 << 18:
        raise ValueError(f"M={g.M}: the tie lanes need 3 M < 2**18")
    N = len(g.lams)
    draws = SweepDraws(g, dev)
    speed, inv, seg = _speed_table(g, dev)
    st = ref.State(N, g.M, (g.M, 3), fdt, dev)
    half2 = g.warmup + (g.T - g.warmup) // 2
    for t in range(g.T):
        k = seg[:, t]
        x = _slot(g, st, draws(t), speed[k], inv[k], fdt)
        if t < g.warmup:
            continue
        s = st.sums
        s["slots"] += 1.0
        s["sum_N"] += x["N"]
        s["sum_N_h2" if t >= half2 else "sum_N_h1"] += x["N"]
        for key in ("arrivals", "clipped", "completions", "busy", "route_decisions",
                    "sched_decisions", "starts", "routed"):
            s[key] += x[key]
    return ref.summarize(st.sums, g)
