"""Placement-aware capacity edge: the fluid LP behind ``lam_cap``.

Copy of ``repro.scenarios.capacity`` (numpy and scipy, on the host).  It
reads a ScenarioData whose leaves are numpy arrays or torch tensors on any
device (``build.host``).

The closed form in :func:`build.capacity_scale` prices the fleet axis only
(time-averaged LOCAL speeds: every task is assumed servable locally at the
boundary).  That is exact for uniform placement — random replica triples
spread demand so thinly that local capacity never binds — but under a
Zipf-skewed or adversarial catalog the hot chunks saturate their few local
servers long before ``lam = alpha * sum_m speed_m``, and the spill-over is
served at the slower beta/gamma tiers.  The honest edge is the optimum of
the fluid LP over per-(chunk, server) flow rates (GB-PANDAS, arXiv
1709.08115; the three-locality-level model of arXiv 1702.07802):

    maximize   lam
    subject to sum_s w_s * sum_m mu_s[c, m] * x[s, c, m]  >=  lam * pbar_c
               sum_c x[s, c, m]  <=  1          for every (segment s, server m)
               0 <= x <= 1,  lam >= 0

where ``x[s, c, m]`` is the fraction of server m's time spent on chunk c
during speed segment s, ``mu_s[c, m] = rates[g] * speed_s[m, g]`` with
``g = locality_class(c, m)`` (LOCAL if m holds a replica, RACK if m shares
a rack with one, REMOTE otherwise), ``w_s`` the segment's share of the run,
and ``pbar_c`` chunk c's time-averaged popularity (churn epochs weighted by
their slot counts).  Queues buffer across segments and epochs, so demand
and capacity both integrate over the run — the same time-averaged stance
``capacity_scale`` already takes for speed windows.

``capacity_edge`` is the dispatcher ``build.realize`` calls: uniform
placement keeps the closed form bit-for-bit (fast path + the historical
contract), skewed catalogs get the LP optimum.  Everything here is
host-side numpy/scipy — nothing runs under jit, so the one-compile sweep
invariant is untouched.  Results are memoized on array content: realizing
the same scenario repeatedly (canonical_a_max, stack_scenarios, grids)
solves each LP once per process.

Requires scipy (HiGHS via ``scipy.optimize.linprog``).  Without scipy the
module falls back to the closed form with a loud one-time warning — edges
for skewed placements are then optimistic, exactly the pre-LP behavior.
"""
from __future__ import annotations

import hashlib
import warnings
from typing import TYPE_CHECKING

import numpy as np

from .build import ScenarioData, capacity_scale, host

if TYPE_CHECKING:  # runtime import would cycle through core.simulator
    from ..core.cluster import Cluster, Rates

try:  # scipy is a default dependency but everything degrades without it
    from scipy import sparse as _sparse
    from scipy.optimize import linprog as _linprog

    HAVE_SCIPY = True
except Exception:  # pragma: no cover - exercised only on scipy-less hosts
    _sparse = _linprog = None
    HAVE_SCIPY = False

_LOCAL, _RACK, _REMOTE = 0, 1, 2      # mirror core.cluster (import would cycle)

_EDGE_CACHE: dict = {}
_EDGE_CACHE_MAX = 256

_warned_no_scipy = False


def uniform_edge(scen: ScenarioData, rates: "Rates", T: int) -> float:
    """The fleet-axis closed form: ``alpha * M * capacity_scale`` — exact
    for uniform placement and bit-for-bit the pre-LP ``lam_cap``."""
    return rates.alpha * scen.M * capacity_scale(scen, T)


def speed_segments(scen: ScenarioData, T: int) -> list:
    """``[(slots, speed [M, 3] float64), ...]`` — the run as piecewise-
    constant speed segments (windows make speed piecewise constant), with
    identical-speed segments merged (their slot counts add; allocation in
    the LP is per distinct speed matrix, not per calendar interval)."""
    start = host(scen.win_start, np.int64)
    end = host(scen.win_end, np.int64)
    bounds = np.unique(np.clip(np.concatenate(
        [[0, T], start, end]), 0, T)).astype(np.int64)
    base = host(scen.base_speed, np.float64)[:, None]      # [M, 1]
    mult = host(scen.win_mult, np.float64)                 # [E, M, 3]
    segs: dict = {}
    order = []
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        active = (start <= lo) & (lo < end)                      # [E]
        sp = base * np.where(active[:, None, None], mult, 1.0).prod(axis=0)
        key = sp.tobytes()
        if key not in segs:
            segs[key] = [0, sp]
            order.append(key)
        segs[key][0] += int(hi - lo)
    return [(segs[k][0], segs[k][1]) for k in order]


def chunk_demand(scen: ScenarioData, T: int):
    """``(pbar [C] float64, locals [C, n_rep] int64)`` — each chunk's
    time-averaged popularity (churn epochs weighted by their slot counts;
    epoch rows are CONDITIONAL popularity while active) and replica triple.
    Pad rows (_PAD_LOGIT) underflow to exactly 0 popularity."""
    locals_ = host(scen.chunk_locals, np.int64)
    if scen.epoch_logits is not None:
        elog = host(scen.epoch_logits, np.float64)         # [P, C]
        P = elog.shape[0]
        if scen.placement_epoch is not None:
            pe = host(scen.placement_epoch)
            counts = np.bincount(pe, minlength=P).astype(np.float64)
        else:
            counts = np.zeros(P)
            counts[0] = float(T)
        with np.errstate(under="ignore"):
            p = np.exp(elog)
        norm = p.sum(axis=1, keepdims=True)
        p = np.divide(p, norm, out=np.zeros_like(p), where=norm > 0)
        pbar = (counts[:, None] / float(T) * p).sum(axis=0)
    else:
        with np.errstate(under="ignore"):
            pbar = np.exp(host(scen.chunk_logits, np.float64))
        pbar = pbar / max(pbar.sum(), 1e-300)
    return pbar, locals_


def _locality_classes(locals_: np.ndarray, M: int, K: int) -> np.ndarray:
    """[G, M] int8 locality class of every (chunk group, server) pair."""
    R = M // K
    rack_of = np.arange(M) // R
    G = locals_.shape[0]
    cls = np.full((G, M), _REMOTE, np.int8)
    for g in range(G):
        locs = locals_[g]
        cls[g, np.isin(rack_of, np.unique(locs // R))] = _RACK
        cls[g, locs] = _LOCAL
    return cls


def fluid_edge(scen: ScenarioData, cluster: "Cluster", rates: "Rates",
               T: int) -> float:
    """Solve the fluid LP (module docstring) and return its optimum —
    the largest total arrival rate (tasks/slot) for which per-chunk demand
    fits inside the per-(segment, server) time budget.  Host-side only;
    raises RuntimeError if HiGHS reports anything but an optimal solution
    and ImportError when scipy is unavailable."""
    if not HAVE_SCIPY:  # pragma: no cover - exercised only without scipy
        raise ImportError("fluid_edge needs scipy (scipy.optimize.linprog)")
    pbar, locals_ = chunk_demand(scen, T)
    # chunks sharing a replica triple are interchangeable in every
    # constraint: merge them (their demands add) before sizing the LP
    trip = np.sort(locals_, axis=1)
    uniq, inv = np.unique(trip, axis=0, return_inverse=True)
    pbar_g = np.zeros(uniq.shape[0])
    np.add.at(pbar_g, inv, pbar)
    live = pbar_g > 1e-15                    # pad rows carry exactly 0 mass
    uniq, pbar_g = uniq[live], pbar_g[live]
    total = pbar_g.sum()
    if total <= 0:
        # an all-pad catalog is a uniform scenario in disguise
        return uniform_edge(scen, rates, T)
    pbar_g = pbar_g / total
    G = uniq.shape[0]
    M = cluster.M
    segs = speed_segments(scen, T)
    S = len(segs)
    cls = _locality_classes(uniq, M, cluster.K)                  # [G, M]
    rates_arr = np.array([rates.alpha, rates.beta, rates.gamma], np.float64)

    # variables: z = [lam, x_0 .. x_{n-1}]; only (s, g, m) with mu > 0
    rows, cols, vals = [], [], []
    next_var = 1
    cap_ub = 0.0                     # sum of best-class service rates: lam ub
    midx = np.arange(M)
    for s, (slots, sp) in enumerate(segs):
        w = slots / float(T)
        sp_cls = sp[midx[None, :], cls]                          # [G, M]
        mu = rates_arr[cls] * sp_cls                             # [G, M]
        cap_ub += w * (rates_arr[None, :, None]
                       * sp.T[None, :, :]).max(axis=(0, 1)).sum()
        gi, mi = np.nonzero(mu > 0)
        n = gi.size
        ids = next_var + np.arange(n)
        next_var += n
        # demand rows (one per group): -(w * mu) * x
        rows.append(gi)
        cols.append(ids)
        vals.append(-w * mu[gi, mi])
        # server-time rows (one per (segment, server)): + x <= 1
        rows.append(G + s * M + mi)
        cols.append(ids)
        vals.append(np.ones(n))
    # lam column in every demand row: + pbar_g * lam <= served mass
    rows.append(np.arange(G))
    cols.append(np.zeros(G, np.int64))
    vals.append(pbar_g)
    n_vars = next_var
    n_rows = G + S * M
    A = _sparse.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n_rows, n_vars)).tocsr()
    b = np.concatenate([np.zeros(G), np.ones(S * M)])
    c = np.zeros(n_vars)
    c[0] = -1.0                                  # maximize lam
    bounds = np.ones((n_vars, 2))
    bounds[:, 0] = 0.0
    bounds[0, 1] = max(cap_ub, 1e-12)
    res = _linprog(c, A_ub=A, b_ub=b, bounds=bounds, method="highs")
    if not res.success:  # pragma: no cover - defensive; LP is always feasible
        raise RuntimeError(
            f"capacity LP failed ({res.status}: {res.message}) — "
            f"G={G} groups, M={M} servers, {S} segments")
    return max(0.0, float(-res.fun))


def _is_uniform(scen: ScenarioData) -> bool:
    """True when the scenario places uniformly (no catalog, or a canonical
    padding whose data-selected law is the uniform branch)."""
    if scen.chunk_locals is None or scen.chunk_logits is None:
        return True
    if scen.placement_on is not None and \
            float(host(scen.placement_on)) == 0.0:
        return True
    return False


def _cache_key(scen: ScenarioData, cluster: "Cluster", rates: "Rates",
               T: int) -> bytes:
    h = hashlib.sha1()
    h.update(np.int64([T, cluster.M, cluster.K, cluster.n_replicas]).tobytes())
    h.update(np.float64([rates.alpha, rates.beta, rates.gamma]).tobytes())
    for a in (scen.base_speed, scen.win_start, scen.win_end, scen.win_mult,
              scen.chunk_logits, scen.chunk_locals, scen.epoch_logits,
              scen.placement_epoch):
        h.update(b"|" if a is None else host(a).tobytes())
    return h.digest()


def capacity_edge(scen: ScenarioData, cluster: "Cluster", rates: "Rates",
                  T: int) -> float:
    """The scenario's capacity-region edge ``lam_cap`` (tasks/slot at
    load 1) — what ``build.realize`` returns and every ``load`` knob in the
    repo is a fraction of.

    Uniform placement takes the closed-form fast path (bit-for-bit the
    pre-LP value; the LP reproduces it — see tests' regression identity);
    skewed catalogs get the fluid-LP optimum, which is strictly smaller
    whenever a hot chunk's demand overflows its local tier at the fleet
    edge.  Memoized on array content, so repeated realizations (grids,
    stacked sweeps, canonical_a_max) solve each LP once per process."""
    if _is_uniform(scen):
        return uniform_edge(scen, rates, T)
    if not HAVE_SCIPY:  # pragma: no cover - exercised only without scipy
        global _warned_no_scipy
        if not _warned_no_scipy:
            _warned_no_scipy = True
            warnings.warn(
                "scipy unavailable: capacity_edge falls back to the "
                "fleet-only closed form — lam_cap is OPTIMISTIC for "
                "Zipf/adversarial placements (install scipy for the "
                "fluid-LP edge)", RuntimeWarning, stacklevel=2)
        return uniform_edge(scen, rates, T)
    key = _cache_key(scen, cluster, rates, T)
    hit = _EDGE_CACHE.get(key)
    if hit is not None:
        return hit
    val = fluid_edge(scen, cluster, rates, T)
    if len(_EDGE_CACHE) >= _EDGE_CACHE_MAX:
        _EDGE_CACHE.pop(next(iter(_EDGE_CACHE)))
    _EDGE_CACHE[key] = val
    return val
