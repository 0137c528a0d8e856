"""Host-side telemetry sinks: collected state -> JSONL events + manifest.

Copy of ``repro.telemetry.export`` (numpy), plus ``to_numpy``: the port's
``Telemetry`` holds tensors, possibly on the card, and every function here
first takes its leaves to numpy on the host (``to_numpy``), so the rest is
the reference's code on the reference's arrays.

JSONL event stream (one JSON object per line), schema version 1:

  {"event": "run", "schema": 1, ...}        run manifest: scenario, algo,
      d, load, seeds, T, warmup, window_len, n_windows, wall_s,
      trace_count, plus anything the caller adds.  Always first.
  {"event": "window", "w": int, "t0": int, "t1": int, "slots": float,
      "mean_N": float, "max_N": float, "throughput": float,
      "utilization": float, "arrivals": float, "clip_fraction": float,
      "q_local"/"q_rack"/"q_remote": float, "w_mean": float,
      "w_max": float, "probe_rank": float|null, "probe_regret": float|null,
      "probe_decisions": float}             one per telemetry window.
  {"event": "histogram", "name": "sojourn"|"queue_len"|"workload",
      "window": int|null, "bins_per_octave": int, "counts": [...]}
      per-window for queue_len/workload (and an aggregate with
      window=null), whole-run for sojourn.
  {"event": "percentiles", "name": "sojourn", "p50": float, "p95": float,
      "p99": float, "n": float, "dropped": float}

``validate_events`` checks this shape; ``scripts/validate_telemetry.py``
checks a JSONL file of it.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from .collectors import WINDOW_MAXES, WINDOW_SUMS, Telemetry, TelemetryConfig
from .hist import percentiles

SCHEMA_VERSION = 1

_S = {n: i for i, n in enumerate(WINDOW_SUMS)}
_X = {n: i for i, n in enumerate(WINDOW_MAXES)}


def to_numpy(tele: Telemetry) -> Telemetry:
    """The same Telemetry with numpy leaves on the host (None stays None;
    numpy leaves pass through).  Grid runs already lead their leaves by the
    reference's grid axes."""
    def leaf(x):
        if x is None:
            return None
        return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)
    return Telemetry(*map(leaf, tele))


def cell_view(tele: Telemetry, idx) -> Telemetry:
    """Index one grid cell (or a cell slab) out of batched telemetry.

    ``simulate_grid`` / ``simulate_sweep`` telemetry carries leading batch
    axes on every leaf ([seeds, loads] resp. [scenarios, seeds, loads]);
    ``idx`` is any numpy index into those axes — e.g. ``(s, slice(None),
    l)`` for one sweep cell's seed replications.  The mega-sweep contract
    is that collectors reduce PER CELL: always slice the cell first with
    this and aggregate the remainder, never ``aggregate`` across cells of
    different scenarios/loads (their windows would sum into one
    meaningless series).  Rings are per-run state and are dropped.
    """
    tele = to_numpy(tele)
    f = lambda x: None if x is None else np.asarray(x)[idx]  # noqa: E731
    return Telemetry(
        win=f(tele.win), win_max=f(tele.win_max),
        qlen_hist=f(tele.qlen_hist), work_hist=f(tele.work_hist),
        sojourn_hist=f(tele.sojourn_hist),
        sojourn_dropped=f(tele.sojourn_dropped),
    )


def aggregate(tele: Telemetry) -> Telemetry:
    """Reduce vmapped (``simulate_grid``) telemetry over its leading batch
    axes: counts/sums add, maxima max, rings are dropped (per-run state).
    For ``simulate_sweep`` telemetry, slice a single (scenario, load) cell
    with ``cell_view`` FIRST — aggregating across heterogeneous cells mixes
    their window series into something meaningless."""
    tele = to_numpy(tele)
    win = np.asarray(tele.win, np.float64)
    extra = win.ndim - 2
    if extra == 0:
        return tele._replace(ring=None, head=None, tail=None, cur_arr=None)
    ax = tuple(range(extra))
    return Telemetry(
        win=win.sum(axis=ax),
        win_max=np.asarray(tele.win_max, np.float64).max(axis=ax),
        qlen_hist=np.asarray(tele.qlen_hist, np.float64).sum(axis=ax),
        work_hist=np.asarray(tele.work_hist, np.float64).sum(axis=ax),
        sojourn_hist=np.asarray(tele.sojourn_hist, np.float64).sum(axis=ax),
        sojourn_dropped=np.asarray(tele.sojourn_dropped,
                                   np.float64).sum(),
    )


def window_records(tele: Telemetry, tcfg: TelemetryConfig, T: int) -> list:
    """Derived per-window rows (means from sums; empty windows skipped)."""
    tele = aggregate(tele)
    win = np.asarray(tele.win, np.float64)
    wmax = np.asarray(tele.win_max, np.float64)
    wl = tcfg.window_len(T)
    rows = []
    for w in range(win.shape[0]):
        slots = win[w, _S["slots"]]
        if slots <= 0:
            continue
        s = lambda n: float(win[w, _S[n]])  # noqa: E731
        arr = s("arrivals")
        probe_n = s("probe_decisions")
        rows.append({
            "event": "window", "w": w, "t0": w * wl,
            "t1": min((w + 1) * wl, T), "slots": slots,
            "mean_N": s("sum_N") / slots,
            "max_N": float(wmax[w, _X["max_N"]]),
            "throughput": s("completions") / slots,
            "utilization": s("busy") / slots,   # busy-server slots per slot
            "arrivals": arr / slots,
            "clip_fraction": s("clipped") / max(arr + s("clipped"), 1.0),
            "q_local": s("q_local") / slots,
            "q_rack": s("q_rack") / slots,
            "q_remote": s("q_remote") / slots,
            "w_mean": s("w_mean") / slots,
            "w_max": s("w_max") / slots,
            "probe_rank": s("probe_rank") / probe_n if probe_n else None,
            "probe_regret": s("probe_regret") / probe_n if probe_n else None,
            "probe_decisions": probe_n,
        })
    return rows


def probe_summary(tele: Telemetry) -> dict:
    """Run-level mean probe rank / regret over all pod decisions."""
    win = np.asarray(aggregate(tele).win, np.float64).sum(axis=0)
    n = win[_S["probe_decisions"]]
    return {
        "decisions": float(n),
        "mean_rank": float(win[_S["probe_rank"]] / n) if n else None,
        "mean_regret": float(win[_S["probe_regret"]] / n) if n else None,
    }


def sojourn_percentiles(tele: Telemetry, tcfg: TelemetryConfig,
                        ps=(50, 95, 99)) -> dict:
    """Per-task sojourn p50/p95/p99 (slots) from the run's log-spaced
    histogram, plus sample count and dropped-record count."""
    tele = aggregate(tele)
    hist = np.asarray(tele.sojourn_hist, np.float64)
    vals = percentiles(hist, ps, tcfg.bins_per_octave)
    out = {f"p{p}": v for p, v in zip(ps, vals)}
    out["n"] = float(hist.sum())
    out["dropped"] = float(np.asarray(tele.sojourn_dropped))
    if out["n"] == 0:
        # NaN percentiles are deliberate — an empty histogram has no
        # quantiles; consumers surface this note instead of printing NaN
        # as if it were a measurement (benchmarks/scenarios.py)
        out["note"] = ("empty sojourn histogram (0 completions recorded): "
                       "percentiles are NaN")
    return out


def windowed_drift(tele: Telemetry, tcfg: TelemetryConfig, T: int,
                   warmup: int) -> float:
    """Drift from the telemetry ring: mean N over the last quarter of
    post-warmup windows divided by the first quarter.  ~1 means the chain
    mixed; >> 1 means still growing (slow mixing or supercritical) — the
    windowed upgrade of SimResult.drift's single half2/half1 ratio, and
    the signal ``auto_extend_warmup`` consumes.

    Returns NaN when fewer than 2 measured windows remain after ``warmup``
    — drift is then UNMEASURABLE, and consumers must treat that as "not
    converged / extend", never as "converged" (the auto-extend loop and
    the benchmark tables both guard this)."""
    tele = aggregate(tele)
    win = np.asarray(tele.win, np.float64)
    wl = tcfg.window_len(T)
    w0 = -(-warmup // wl)                        # first fully-measured window
    slots = win[w0:, _S["slots"]]
    meas = np.where(slots > 0)[0]
    if len(meas) < 2:
        return float("nan")
    mean_N = win[w0:, _S["sum_N"]][meas] / slots[meas]
    k = max(1, len(meas) // 4)
    head, tail = mean_N[:k].mean(), mean_N[-k:].mean()
    return float(tail / max(head, 1e-9))


# ---------------------------------------------------------------------------
# Drift-aware auto-extend warmup (ROADMAP: slow-mixing scenarios must
# converge before measurement).  Window sums are EXACT per-slot sums, so
# moving the measurement boundary to a later window boundary and re-deriving
# the tail statistics is equivalent to having run with that longer warmup —
# no re-run, no retrace, the one-compile sweep invariant holds trivially.
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class WarmupPolicy:
    """Knobs of the auto-extend warmup loop (``auto_extend_warmup``).

    threshold        converged when windowed drift < this (1.05 = the last
                     quarter of measured windows is within 5% of the first)
    chunk_windows    extend the warmup boundary by this many telemetry
                     windows per step
    max_warmup_frac  hard cap: never push warmup past this fraction of T
                     (measurement needs a tail; past the cap the honest
                     answer is "lengthen the run", not "trim harder")
    min_tail_windows stop extending when fewer measured windows than this
                     would remain (a 2-window drift estimate is noise)
    """

    threshold: float = 1.05
    chunk_windows: int = 2
    max_warmup_frac: float = 0.75
    min_tail_windows: int = 4


class WarmupReport(NamedTuple):
    """Outcome of one auto-extend warmup pass (``auto_extend_warmup``).

    ``warmup`` is the REALIZED measurement boundary (slots; recorded in
    benchmark rows and JSONL manifests), ``drift`` the windowed drift of
    the surviving tail, and the trailing fields the tail's re-derived
    metrics (means over the post-``warmup`` windows; ``mean_completion``
    is Little's-law slots).  ``converged`` is False whenever drift is NaN
    (unmeasurable — never treated as converged) or still >= threshold at
    the cap; ``note`` then says why, loudly."""

    warmup0: int
    warmup: int
    extensions: int
    converged: bool
    drift0: float
    drift: float
    threshold: float
    mean_N: float
    lam_hat: float
    mean_completion: float
    throughput: float
    note: str = ""

    def fields(self) -> dict:
        """Manifest/benchmark-row fields (JSON-safe floats)."""
        return {
            "warmup0": self.warmup0,
            "warmup_realized": self.warmup,
            "warmup_extensions": self.extensions,
            "warmup_converged": self.converged,
            "drift_windowed0": float(self.drift0),
            "drift_windowed": float(self.drift),
            "drift_threshold": float(self.threshold),
            **({"warmup_note": self.note} if self.note else {}),
        }


def tail_stats(tele: Telemetry, tcfg: TelemetryConfig, T: int,
               warmup: int) -> dict:
    """Re-derive run metrics from the telemetry windows at/after the
    ``warmup`` boundary (exact: window sums are per-slot sums, so this
    equals a run measured with that warmup up to window granularity).
    Returns mean_N / lam_hat / mean_completion (Little's law, slots) /
    throughput — NaN-filled when no measured window survives."""
    tele = aggregate(tele)
    win = np.asarray(tele.win, np.float64)
    wl = tcfg.window_len(T)
    w0 = -(-int(warmup) // wl)
    tail = win[w0:]
    slots = float(tail[:, _S["slots"]].sum())
    if slots <= 0:
        nan = float("nan")
        return {"mean_N": nan, "lam_hat": nan, "mean_completion": nan,
                "throughput": nan}
    mean_N = float(tail[:, _S["sum_N"]].sum()) / slots
    lam_hat = float(tail[:, _S["arrivals"]].sum()) / slots
    return {
        "mean_N": mean_N,
        "lam_hat": lam_hat,
        "mean_completion": mean_N / max(lam_hat, 1e-9),
        "throughput": float(tail[:, _S["completions"]].sum()) / slots,
    }


def auto_extend_warmup(tele: Telemetry, tcfg: TelemetryConfig, T: int,
                       warmup: int,
                       policy: WarmupPolicy = WarmupPolicy()
                       ) -> WarmupReport:
    """The drift-aware warmup control loop (ROADMAP auto-extend).

    Starting from the run's configured ``warmup``, extend the measurement
    boundary in chunks of ``policy.chunk_windows`` telemetry windows while
    the windowed drift of the remaining tail is >= ``policy.threshold``,
    stopping at the ``max_warmup_frac`` cap or when the surviving tail
    gets too short to judge (``min_tail_windows``).  A NaN drift
    (unmeasurable: < 2 measured windows) is NEVER treated as converged —
    the report comes back converged=False with a loud note.

    Works on collected window sums only — the simulation is not re-run and
    nothing retraces, so a fast-mixing run (drift already below threshold)
    costs zero extensions and a sweep's trace_count stays at 1.  Use
    ``core.simulate_auto_warmup`` for the one-call version.
    """
    tele = aggregate(tele)
    wl = tcfg.window_len(T)
    cap = int(policy.max_warmup_frac * T)
    win = np.asarray(tele.win, np.float64)
    measured_after = lambda w: int(  # noqa: E731
        (win[-(-int(w) // wl):, _S["slots"]] > 0).sum())
    w = int(warmup)
    drift0 = windowed_drift(tele, tcfg, T, w)
    drift = drift0
    extensions = 0
    note = ""
    while not math.isnan(drift) and drift >= policy.threshold:
        nxt = w + policy.chunk_windows * wl
        if nxt > cap:
            note = (f"NOT converged: drift {drift:.3f} >= "
                    f"{policy.threshold} at the warmup cap ({cap} slots = "
                    f"{policy.max_warmup_frac:.0%} of T) — lengthen the "
                    "run (larger T), the tail cannot be trimmed further")
            break
        if measured_after(nxt) < policy.min_tail_windows:
            note = (f"NOT converged: drift {drift:.3f} >= "
                    f"{policy.threshold} but only "
                    f"{measured_after(nxt)} measured windows would remain "
                    f"(< min_tail_windows={policy.min_tail_windows}) — "
                    "lengthen the run (larger T)")
            break
        w = nxt
        extensions += 1
        drift = windowed_drift(tele, tcfg, T, w)
    if math.isnan(drift):
        converged = False
        if not note:
            note = ("drift UNMEASURABLE (fewer than 2 measured telemetry "
                    "windows after warmup) — treated as NOT converged; "
                    "lengthen the run or use more telemetry windows")
    else:
        converged = bool(drift < policy.threshold)
    return WarmupReport(
        warmup0=int(warmup), warmup=w, extensions=extensions,
        converged=converged, drift0=float(drift0), drift=float(drift),
        threshold=float(policy.threshold), note=note,
        **tail_stats(tele, tcfg, T, w))


# ---------------------------------------------------------------------------
# JSONL events
# ---------------------------------------------------------------------------


def run_manifest(**fields) -> dict:
    """The run-manifest event; callers pass scenario/algo/d/load/seeds/
    T/warmup/wall_s/trace_count and any extra context."""
    return {"event": "run", "schema": SCHEMA_VERSION, **fields}


def to_events(tele: Telemetry, tcfg: TelemetryConfig, T: int, warmup: int,
              manifest: Optional[dict] = None,
              per_window_hists: bool = False) -> list:
    """Flatten one run's collected telemetry into the JSONL event list."""
    tele = aggregate(tele)
    events = []
    if manifest is not None:
        m = dict(manifest)
        m.setdefault("event", "run")
        m.setdefault("schema", SCHEMA_VERSION)
        m["n_windows"] = tcfg.n_windows
        m["window_len"] = tcfg.window_len(T)
        m["drift_windowed"] = windowed_drift(tele, tcfg, T, warmup)
        events.append(m)
    events.extend(window_records(tele, tcfg, T))
    bpo = tcfg.bins_per_octave
    for name, h in (("queue_len", tele.qlen_hist),
                    ("workload", tele.work_hist)):
        h = np.asarray(h, np.float64)
        events.append({"event": "histogram", "name": name, "window": None,
                       "bins_per_octave": bpo,
                       "counts": h.sum(axis=0).tolist()})
        if per_window_hists:
            for w in range(h.shape[0]):
                if h[w].sum() > 0:
                    events.append({"event": "histogram", "name": name,
                                   "window": w, "bins_per_octave": bpo,
                                   "counts": h[w].tolist()})
    events.append({"event": "histogram", "name": "sojourn", "window": None,
                   "bins_per_octave": bpo,
                   "counts": np.asarray(tele.sojourn_hist,
                                        np.float64).tolist()})
    events.append({"event": "percentiles", "name": "sojourn",
                   **sojourn_percentiles(tele, tcfg)})
    return events


def write_jsonl(path: str, events: list, append: bool = True) -> None:
    """Write events (one JSON object per line) to ``path``, creating parent
    directories; ``append=False`` truncates an existing file."""
    parent = os.path.dirname(os.path.abspath(path))
    if parent:
        os.makedirs(parent, exist_ok=True)
    with open(path, "a" if append else "w") as f:
        for e in events:
            f.write(json.dumps(e) + "\n")


def read_jsonl(path: str) -> list:
    """Load a JSONL event stream back into a list of dicts (blank lines
    skipped) — the inverse of ``write_jsonl``."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


_REQUIRED = {
    "run": ("schema",),
    "window": ("w", "t0", "t1", "slots", "mean_N", "max_N", "throughput",
               "utilization", "arrivals", "clip_fraction"),
    "histogram": ("name", "window", "bins_per_octave", "counts"),
    "percentiles": ("name", "n"),
}


def validate_events(events: list) -> list:
    """Schema check; returns a list of error strings (empty == valid)."""
    errors = []
    if not events:
        return ["empty event stream"]
    if events[0].get("event") != "run":
        errors.append("first event must be the run manifest")
    for i, e in enumerate(events):
        kind = e.get("event")
        if kind not in _REQUIRED:
            errors.append(f"line {i + 1}: unknown event {kind!r}")
            continue
        missing = [k for k in _REQUIRED[kind] if k not in e]
        if missing:
            errors.append(f"line {i + 1} ({kind}): missing {missing}")
        if kind == "run" and e.get("schema") != SCHEMA_VERSION:
            errors.append(f"line {i + 1}: schema {e.get('schema')} != "
                          f"{SCHEMA_VERSION}")
        if kind == "histogram" and not isinstance(e.get("counts"), list):
            errors.append(f"line {i + 1}: histogram counts must be a list")
    return errors


# ---------------------------------------------------------------------------
# Clip-fraction surfacing (satellite): silent arrival clipping biases
# results invisibly — callers of simulate_grid print this loudly.
# ---------------------------------------------------------------------------


def format_clip_warning(cells: list) -> Optional[str]:
    """cells: [(label, clip_fraction), ...]; returns a loud multi-line
    warning for the clipped ones, or None when nothing clipped."""
    hot = [(lbl, f) for lbl, f in cells if f > 0]
    if not hot:
        return None
    lines = ["!" * 72,
             "! WARNING: arrival clipping detected — Poisson draws above "
             "a_max were",
             "! truncated; measured loads are BIASED LOW in these cells "
             "(raise a_max):"]
    for lbl, f in sorted(hot, key=lambda x: -x[1]):
        lines.append(f"!   {lbl}: clip_fraction = {f:.3e}")
    lines.append("!" * 72)
    return "\n".join(lines)
