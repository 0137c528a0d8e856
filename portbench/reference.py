"""Plain PyTorch reference of a simulation grid: the paper's slotted model
(arXiv:1904.00447 §III-IV), written from its semantics, for the comparison
that decides a run's ``correct``.

It imports torch alone and nothing of the program.  Given a grid's cells
(one arrival rate and one generator seed each), it works the random draws
out again from the seeds, in the same calls on the same device as the
program's draw source (a frozen copy of that procedure: the draws are the
simulation's input), then runs the slot loop one cell axis at a time and
one arrival at a time, and returns each cell's summary statistics.

Slot order: completions -> scheduling -> arrivals and routing ->
accumulators.  Balanced-Pandas routing commits arrival by arrival: each
arrival scores every server (full) or its candidate list (Pod) against the
workloads the earlier arrivals of its slot left, and the least (score,
class, tie priority, index) wins.  JSQ-MaxWeight-Pod schedules up to
``s_max`` idle servers a slot, each against its own queue and d' sampled
queues, grants resolved by weight then by a uniform; arrivals join the
shortest of their three local queues.

``fdt`` is the floating type of the slot state and its arithmetic (remaining
work, workloads, scores and weights): float32 is the configuration's, and
bfloat16 is the control that the comparison has to fail.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

LOCAL, RACK, REMOTE = 0, 1, 2
_F = torch.float32
_BLOCK_ELEMS = 1 << 22
_MAX_DURATION = 1_000_000

FIELDS = ("mean_tasks_in_system", "mean_completion_slots",
          "mean_completion_norm", "arrival_rate_hat", "throughput",
          "utilization", "locality_fractions", "routed_fractions", "drift",
          "clip_fraction", "route_decisions", "sched_decisions",
          "route_candidates_per_decision", "sched_candidates_per_decision")


class Grid(NamedTuple):
    """What one grid call simulates: the configuration and its cells."""

    algo: str            # balanced_pandas | balanced_pandas_pod | jsq_maxweight_pod
    M: int
    K: int
    rates: tuple         # (alpha, beta, gamma)
    pod: tuple           # (d_rack, d_remote), () for full Balanced-Pandas
    T: int
    warmup: int
    a_max: int
    s_max: int
    lams: list           # float arrival rate of each cell
    seeds: list          # generator seed of each cell


# ---------------------------------------------------------------------------
# Draws: the same generator calls, in the same order, as the program's source
# ---------------------------------------------------------------------------

def _rand(gen, shape, dev):
    return torch.rand(shape, generator=gen, device=dev, dtype=_F)


def _uniform_int(gen, shape, high, dev):
    return (_rand(gen, shape, dev) * high).to(torch.int32)


def _durations(gen, p, n, rows, dev):
    u = _rand(gen, (n, rows, 1), dev) * (1.0 - 2e-7) + 1e-7
    d = torch.ceil(torch.log1p(-u) / torch.log1p(-p))
    return torch.clamp(d, 1, _MAX_DURATION).to(torch.int32)


def _replicas(gen, M, batch, dev):
    """Three distinct servers a task: the i-th uniform among the M - i not
    yet taken, mapped past the earlier picks in ascending order."""
    high = torch.arange(M, M - 3, -1, dtype=_F, device=dev)
    u = _uniform_int(gen, (batch, 3), high, dev)
    picks = [u[:, 0]]
    for i in (1, 2):
        d = u[:, i]
        prev = torch.stack(picks, 1).sort(dim=1).values if i > 1 else picks[0][:, None]
        for j in range(i):
            d = d + (d >= prev[:, j])
        picks.append(d)
    return torch.stack(picks, 1)


def classes(locals_, M, R):
    """int32 [..., M] locality class of every server for tasks whose
    replicas are ``locals_`` [..., 3]."""
    m = torch.arange(M, dtype=torch.int32, device=locals_.device)
    local = (locals_[..., None] == m).any(dim=-2)
    rack = ((locals_ // R)[..., None] == (m // R)).any(dim=-2)
    return torch.where(local, LOCAL, torch.where(rack, RACK, REMOTE)).to(torch.int32)


def _set_draws(gen, sets, k, dev):
    """k uniform members (with replacement) of each row of ``sets``, by
    counting: the (u+1)-th member is the number of prefix counts <= u."""
    csum = torch.cumsum(sets.to(torch.int32), dim=-1, dtype=torch.int32)
    total = csum[..., -1:]
    u = _uniform_int(gen, sets.shape[:-1] + (k,), torch.clamp_min(total, 1), dev)
    idx = (csum[..., None, :] <= u[..., :, None]).sum(dim=-1, dtype=torch.int32)
    return torch.clamp_max(idx, sets.shape[-1] - 1), (total > 0).expand(idx.shape)


def draw_block(g: Grid) -> int:
    """Slots a cell draws at once: up to 256, fewer where a slot's largest
    draw (BP-Pod's candidate counting over [a_max, M]) is large."""
    if g.algo.startswith("jsq"):
        lanes = max(g.M, min(g.s_max, g.M) * (1 + sum(g.pod)))
    elif g.pod:
        lanes = g.a_max * g.M
    else:
        lanes = max(g.M, g.a_max * 3)
    return max(1, min(256, _BLOCK_ELEMS // lanes))


class CellDraws:
    """One cell's draws, a block of slots at a time, from its own generator."""

    def __init__(self, g: Grid, lam: float, seed: int, dev):
        self.g, self.dev = g, dev
        self.gen = torch.Generator(device=dev).manual_seed(int(seed))
        self.lam_t = torch.tensor(lam, dtype=_F, device=dev) * torch.ones(g.T, dtype=_F, device=dev)
        self.p = torch.tensor(g.rates, dtype=_F, device=dev)
        self.S = min(g.s_max, g.M)
        self.block = draw_block(g)
        self.sq = g.algo.startswith("jsq")

    def fill(self, t0: int) -> dict:
        g, gen, dev, M = self.g, self.gen, self.dev, self.g.M
        lam = self.lam_t[t0:t0 + self.block]
        n = lam.shape[0]
        out = {"raw": torch.poisson(lam, generator=gen).to(torch.int32)}
        locals_ = _replicas(gen, M, n * g.a_max, dev).view(n, g.a_max, 3)
        out["locals"] = locals_
        if self.sq:
            R, (dr, dm) = M // g.K, g.pod
            if self.S < M:
                out["rows"] = _rand(gen, (n, M), dev)
            hi = torch.tensor([max(R - 1, 1)] * dr + [max(M - R, 1)] * dm, dtype=_F, device=dev)
            out["cand"] = _uniform_int(gen, (n, self.S, dr + dm), hi, dev)
            out["dur"] = _durations(gen, self.p, n, self.S, dev)
            out["tie"] = _rand(gen, (n, self.S, 1 + dr + dm), dev)
            out["grant"] = _rand(gen, (n, self.S), dev)
            return out
        out["dur"] = _durations(gen, self.p, n, M, dev)
        if not g.pod:
            out["prio"] = _rand(gen, (n, M), dev).argsort(dim=1).to(torch.int32)
            return out
        dr, dm = g.pod
        cls = classes(locals_, M, M // g.K)
        idx, ok = _set_draws(gen, torch.stack([cls == RACK, cls == REMOTE]), max(dr, dm), dev)
        out["cand_idx"] = torch.cat([locals_, idx[0, ..., :dr], idx[1, ..., :dm]], dim=-1)
        out["cand_valid"] = torch.cat([torch.ones_like(locals_, dtype=torch.bool),
                                       ok[0, ..., :dr], ok[1, ..., :dm]], dim=-1)
        return out


def a_max_for(lams) -> int:
    """Arrival-buffer width of a grid: from its largest rate's float32
    peak, peak + 6 sqrt(peak) + 4 rounded up (a clipped slot ~1e-9), the
    simulator's documented default."""
    peak = torch.tensor(max(lams), dtype=_F).item()
    return int(math.ceil(peak + 6.0 * math.sqrt(peak) + 4))


def arrivals(g: Grid, dev) -> torch.Tensor:
    """int32 [T, cells]: the arrivals each cell routes in each slot (its
    Poisson count clipped to ``a_max``), from the draws alone."""
    draws, out = GridDraws(g, dev), []
    for t0 in range(0, g.T, draws.block):
        draws(t0)
        out.append(draws.buf["raw_host"])
    return torch.clamp_max(torch.cat(out)[:g.T], g.a_max)


class GridDraws:
    """Every cell's draws of slot t, stacked on a leading cell axis."""

    def __init__(self, g: Grid, dev):
        self.cells = [CellDraws(g, lam, s, dev) for lam, s in zip(g.lams, g.seeds)]
        self.block = self.cells[0].block
        self.t0, self.buf = None, None

    def __call__(self, t: int) -> dict:
        if self.buf is None or not self.t0 <= t < self.t0 + self.block:
            parts = [c.fill(t) for c in self.cells]
            self.t0 = t
            self.buf = {k: torch.stack([p[k] for p in parts], 1) for k in parts[0]}
            self.buf["raw_host"] = self.buf["raw"].cpu()
        i = t - self.t0
        return {k: v[i] for k, v in self.buf.items()}


# ---------------------------------------------------------------------------
# The slot loop
# ---------------------------------------------------------------------------

def _lexmin(score, tie):
    """Index of the least (score, tie) along the last axis.  Scores are >= 0
    or +inf, so their float32 bits order as integers; ``tie`` < 2**18."""
    bits = score.float().view(torch.int32).long()
    return torch.add(tie, bits, alpha=1 << 18).argmin(dim=-1)


def _earlier(B, dev):
    """bool [B, B]: arrival a commits before arrival b (a < b)."""
    return torch.ones((B, B), dtype=torch.bool, device=dev).tril(-1)


def _in_order(decide, B):
    """The picks [N, B] of B arrivals that commit one after another.
    ``decide(picks)`` makes every arrival's pick against the commits of the
    picks before it in ``picks`` (None: no commits).  Arrival b depends on
    arrivals 0..b-1 alone, so each round fixes at least one more arrival
    from the front; the fixed point is the sequential order's picks."""
    picks = decide(None)
    for _ in range(B):
        new = decide(picks)
        if torch.equal(new, picks):
            break
        picks = new
    return picks


class State:
    """Per-cell queues and servers, and the run's float32 accumulators."""

    def __init__(self, N, M, qshape, fdt, dev):
        self.Q = torch.zeros((N,) + qshape, dtype=torch.int32, device=dev)
        self.busy = torch.zeros((N, M), dtype=torch.bool, device=dev)
        self.rem = torch.zeros((N, M), dtype=fdt, device=dev)
        self.cls = torch.zeros((N, M), dtype=torch.int64, device=dev)
        z = lambda *s: torch.zeros((N,) + s, dtype=_F, device=dev)
        self.sums = {k: z() for k in ("slots", "sum_N", "sum_N_h1", "sum_N_h2",
                                      "arrivals", "clipped", "completions", "busy",
                                      "route_decisions", "sched_decisions")}
        self.sums["starts"] = z(3)
        self.sums["routed"] = z(3)


def _serve(st: State):
    """Busy servers do one unit of work; those at 0 complete."""
    rem = torch.where(st.busy, st.rem - 1.0, 0.0).to(st.rem.dtype)
    done = st.busy & (rem <= 0)
    st.busy = st.busy & ~done
    st.rem = torch.where(st.busy, rem, 0.0).to(st.rem.dtype)
    return done.sum(dim=-1).to(_F)


def _start(st: State, idx, go, cls, work):
    """Servers ``idx`` [N, S] that ``go`` start a task of class ``cls``."""
    st.busy = st.busy.scatter(1, idx, st.busy.gather(1, idx) | go)
    st.rem = st.rem.scatter(1, idx, torch.where(go, work.to(st.rem.dtype), st.rem.gather(1, idx)))
    st.cls = st.cls.scatter(1, idx, torch.where(go, cls, st.cls.gather(1, idx)))


def _by_class(cls, on):
    return ((cls[..., None] == torch.arange(3, device=cls.device)) & on[..., None]).sum(dim=-2).to(_F)


def _bp_slot(g: Grid, st: State, d: dict, inv, fdt):
    N, M, dev = st.Q.shape[0], g.M, st.Q.device
    comp = _serve(st)
    # an idle server starts its own head task: local, else rack, else remote
    has = st.Q > 0
    pick = torch.where(has[..., 0], 0, torch.where(has[..., 1], 1, 2))
    go = ~st.busy & has.any(dim=-1)
    st.Q = st.Q - ((pick[..., None] == torch.arange(3, device=dev)) & go[..., None]).to(torch.int32)
    m = torch.arange(M, device=dev).expand(N, M)
    _start(st, m, go, pick, d["dur"].gather(-1, pick[..., None])[..., 0].to(_F))
    starts, n_started = _by_class(pick, go), go.sum(dim=-1).to(_F)

    raw = d["raw"]
    n_arr = torch.clamp_max(raw, g.a_max)
    # workloads in the pinned order (q0/alpha + q1/beta) + q2/gamma
    r = lambda x: x.to(fdt)
    x = [r(st.Q[..., c].to(fdt) * inv[c]) for c in range(3)]
    W = r(r(x[0] + x[1]) + x[2])
    B = int(torch.clamp_max(d["raw_host"], g.a_max).max())
    act = torch.arange(B, device=dev) < n_arr[:, None]                       # [N, B]
    # arrival by arrival, each against W0 + dW: dW holds the slot's commits,
    # added server by server in arrival order (the sum's rounding is part of
    # the result); arrivals past a cell's count commit nothing
    dW = torch.zeros_like(W)
    picks = []
    if B == 0:
        sel = scls = torch.zeros((N, 0), dtype=torch.int64, device=dev)
    elif g.pod:
        C = d["cand_idx"].shape[-1]
        ccls = torch.tensor([LOCAL] * 3 + [RACK] * g.pod[0] + [REMOTE] * g.pod[1], device=dev)
        valid = d["cand_valid"][:, :B]
        tie = ccls * C + torch.arange(C, device=dev) + (~valid).long() * 4 * C   # [N, B, C]
        cand = d["cand_idx"][:, :B].long()
        inv_c = inv[ccls]
        commit = r(inv_c * act[..., None])
        # an invalid candidate (an empty set drawn from) scores +inf
        w0 = torch.where(valid, W.gather(1, cand.flatten(1)).view(cand.shape), math.inf)
        slots = []
        for b in range(B):
            c = cand[:, b]
            j = _lexmin(r(r(w0[:, b] + dW.gather(1, c)) * inv_c), tie[:, b])[:, None]
            s = c.gather(1, j)
            dW.scatter_add_(1, s, commit[:, b].gather(1, j))
            picks.append(s[:, 0])
            slots.append(j[:, 0])
        sel, scls = torch.stack(picks, 1), ccls[torch.stack(slots, 1)]
    else:
        cls_all = classes(d["locals"][:, :B], M, M // g.K).long()           # [N, B, M]
        inv_all = inv[cls_all]
        commit = r(inv_all * act[..., None])
        # ties: the faster class, then the slot's priority (a permutation)
        tie = cls_all * M + d["prio"].long()[:, None, :]
        for b in range(B):
            s = _lexmin(r(r(W + dW) * inv_all[:, b]), tie[:, b])[:, None]
            dW.scatter_add_(1, s, commit[:, b].gather(1, s))
            picks.append(s[:, 0])
        sel = torch.stack(picks, 1)
        scls = cls_all.gather(2, sel[..., None])[..., 0]
    st.Q = st.Q.view(N, -1).scatter_add(1, sel * 3 + scls, act.to(torch.int32)).view(N, M, 3)
    routed = _by_class(scls, act)
    busy_n = st.busy.sum(dim=-1).to(_F)
    Ns = st.Q.sum(dim=(-2, -1)).to(_F) + busy_n
    arr = n_arr.to(_F)
    return dict(N=Ns, arrivals=arr, clipped=(raw - n_arr).to(_F), completions=comp,
                starts=starts, routed=routed, busy=busy_n, route_decisions=arr,
                sched_decisions=n_started)


def _jsqmw_pod_slot(g: Grid, st: State, d: dict, fdt):
    N, M, dev = st.Q.shape[0], g.M, st.Q.device
    R, (dr, dm) = M // g.K, g.pod
    S = min(g.s_max, M)
    comp = _serve(st)
    Q = st.Q
    idle = ~st.busy
    eligible = idle & ((Q > 0) | (Q > 0).any(dim=-1, keepdim=True))
    if S < M:
        key = torch.where(eligible, d["rows"], math.inf)
        rows = torch.argsort(key, dim=-1, stable=True)[:, :S]
    else:
        rows = torch.arange(M, device=dev).expand(N, M)
    act = eligible.gather(1, rows)
    # own queue, d_rack peers of the same rack, d_remote outside it
    start = (rows // R) * R
    x, y = d["cand"][..., :dr].long(), d["cand"][..., dr:].long()
    peers = start[..., None] + x + (x >= (rows - start)[..., None])
    far = y + torch.where(y >= start[..., None], R, 0)
    cand = torch.cat([rows[..., None], peers, far], dim=-1)                # [N, S, 1+d]
    qc = Q.gather(1, cand.flatten(1)).view(cand.shape)
    rate = torch.tensor([g.rates[LOCAL]] + [g.rates[RACK]] * dr + [g.rates[REMOTE]] * dm,
                        dtype=_F, device=dev)
    w = (qc.to(fdt) * rate.to(fdt)).to(fdt)
    ok = qc > 0
    # the heaviest, ties to the lower uniform, then the lower slot
    v = torch.where(ok, w, -math.inf)
    tie = ok & (v == v.amax(dim=-1, keepdim=True))
    u = torch.where(tie, d["tie"], math.inf)
    tie = tie & (u == u.amin(dim=-1, keepdim=True))
    j = torch.argmax(tie.to(torch.uint8), dim=-1)
    tgt = cand.gather(-1, j[..., None])[..., 0]
    val = w.gather(-1, j[..., None])[..., 0]
    has = ok.any(dim=-1) & act
    # claimant i is granted when fewer than Q[tgt] same-target claimants
    # precede it (larger weight, then lower uniform)
    gr = d["grant"]
    before = (val[..., None, :] > val[..., :, None]) | (
        (val[..., None, :] == val[..., :, None]) & (gr[..., None, :] < gr[..., :, None]))
    same = (tgt[..., None, :] == tgt[..., :, None]) & has[..., None, :] & has[..., :, None]
    granted = has & ((same & before).sum(dim=-1) < Q.gather(1, tgt))
    Q = Q.scatter_add(1, tgt, -granted.to(torch.int32))
    scls = torch.where(rows == tgt, LOCAL, torch.where(rows // R == tgt // R, RACK, REMOTE))
    _start(st, rows, granted, scls, d["dur"].gather(-1, scls[..., None])[..., 0].to(_F))
    starts, n_sched = _by_class(scls, granted), has.sum(dim=-1).to(_F)

    raw = d["raw"]
    n_arr = torch.clamp_max(raw, g.a_max)
    B = int(torch.clamp_max(d["raw_host"], g.a_max).max())
    act = torch.arange(B, device=dev) < n_arr[:, None]
    earlier = _earlier(B, dev)
    loc = d["locals"][:, :B].long()                                          # [N, B, 3]
    q0 = Q.gather(1, loc.flatten(1)).view(loc.shape)

    def decide(sel):
        q = q0
        if sel is not None:         # earlier arrivals that joined each local queue
            hit = (sel[:, None, :, None] == loc[:, :, None, :]) & earlier[..., None]
            q = q0 + (hit & act[:, None, :, None]).sum(dim=2)
        # the shortest local queue; ties to the lower replica slot
        return loc.gather(2, q.to(fdt).argmin(dim=-1, keepdim=True))[..., 0]

    if B:
        sel = _in_order(decide, B)
        Q = Q.scatter_add(1, sel, act.to(torch.int32))
    st.Q = Q
    busy_n = st.busy.sum(dim=-1).to(_F)
    arr = n_arr.to(_F)
    return dict(N=Q.sum(dim=-1).to(_F) + busy_n, arrivals=arr,
                clipped=(raw - n_arr).to(_F), completions=comp, starts=starts,
                routed=torch.zeros_like(starts), busy=busy_n, route_decisions=arr,
                sched_decisions=n_sched)


def run(g: Grid, dev, fdt=_F) -> dict:
    """Simulate every cell of ``g``; returns each summary field, [cells, ...]."""
    N, M = len(g.lams), g.M
    draws = GridDraws(g, dev)
    sq = g.algo.startswith("jsq")
    if sq and (g.algo != "jsq_maxweight_pod" or not g.pod):
        raise ValueError(f"the reference has no {g.algo!r}")
    if 3 * M >= 1 << 18:
        raise ValueError(f"M={M}: the tie lanes need 3 M < 2**18")
    st = State(N, M, (M,) if sq else (M, 3), fdt, dev)
    inv = 1.0 / torch.tensor(g.rates, dtype=_F, device=dev)
    half2 = g.warmup + (g.T - g.warmup) // 2
    for t in range(g.T):
        d = draws(t)
        x = _jsqmw_pod_slot(g, st, d, fdt) if sq else _bp_slot(g, st, d, inv, fdt)
        if t < g.warmup:
            continue
        s = st.sums
        s["slots"] += 1.0
        s["sum_N"] += x["N"]
        s["sum_N_h2" if t >= half2 else "sum_N_h1"] += x["N"]
        for k in ("arrivals", "clipped", "completions", "busy", "route_decisions",
                  "sched_decisions", "starts", "routed"):
            s[k] += x[k]
    return summarize(st.sums, g)


def summarize(s: dict, g: Grid) -> dict:
    """The summary statistics of the run's sums (Little's law for the mean
    completion time)."""
    slots = torch.clamp_min(s["slots"], 1.0)
    mean_N = s["sum_N"] / slots
    lam_hat = s["arrivals"] / slots
    mean_T = mean_N / torch.clamp_min(lam_hat, 1e-9)
    h = torch.clamp_min(slots / 2.0, 1.0)
    sq = g.algo.startswith("jsq")
    route_cand = 3 if sq else (3 + sum(g.pod) if g.pod else g.M)
    sched_cand = 1 + sum(g.pod) if sq else 1
    const = lambda x: torch.full_like(slots, float(x))
    return dict(
        mean_tasks_in_system=mean_N,
        mean_completion_slots=mean_T,
        mean_completion_norm=mean_T * g.rates[0],
        arrival_rate_hat=lam_hat,
        throughput=s["completions"] / slots,
        utilization=s["busy"] / (slots * g.M),
        locality_fractions=s["starts"] / torch.clamp_min(s["starts"].sum(-1, keepdim=True), 1.0),
        routed_fractions=s["routed"] / torch.clamp_min(s["routed"].sum(-1, keepdim=True), 1.0),
        drift=torch.where(s["sum_N_h1"] > 0,
                          (s["sum_N_h2"] / h) / torch.clamp_min(s["sum_N_h1"] / h, 1e-30),
                          float("nan")),
        clip_fraction=s["clipped"] / torch.clamp_min(s["arrivals"] + s["clipped"], 1.0),
        route_decisions=s["route_decisions"],
        sched_decisions=s["sched_decisions"],
        route_candidates_per_decision=const(route_cand),
        sched_candidates_per_decision=const(sched_cand),
    )


def gap(got: dict, want: dict) -> torch.Tensor:
    """[cells] largest relative gap of any summary field of a cell:
    |got - want| / max(|want|, 1e-6); two NaNs agree, one NaN is +inf."""
    cols = []
    for k in FIELDS:
        b = want[k].to(torch.float64).reshape(want[k].shape[0], -1)
        a = got[k].to(torch.float64).expand(want[k].shape).reshape(b.shape)
        d = (a - b).abs() / b.abs().clamp_min(1e-6)
        both = a.isnan() & b.isnan()
        d = torch.where(both, 0.0, torch.where(a.isnan() | b.isnan(), math.inf, d))
        cols.append(d)
    return torch.cat(cols, dim=1).amax(dim=1)
