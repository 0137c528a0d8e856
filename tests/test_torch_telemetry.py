"""The port's telemetry against the JAX reference (``repro.telemetry``).

  hist       ``bin_index`` equals the reference's float32 bins exactly, on
             random values and on every float32 within 5 000 steps of each
             bin edge (no value moves across an edge); ``bin_edges``,
             ``np_hist`` and ``percentiles`` are the reference's numbers.
  collectors ``probe_stats_min`` / ``probe_stats_max``: ranks and decision
             counts exact, regret within 1e-6 relative (a float sum in
             another order); ``ring_pop``'s pairwise rank is identically 0
             on BP's queue ids (server m pops only its own sub-queues), so
             skipping it gives the same state.
  export     every function equals the reference's on the same arrays
             (``auto_extend_warmup``'s WarmupReport exactly), and the
             port's JSONL passes scripts/validate_telemetry.py, the
             reference's validator, run unchanged.
  entry      simulate_auto_warmup's SimResult equals
             simulate_with_telemetry's and its report the reference's; the
             entry points take the reference's arguments.

Telemetry on against off: tests/test_torch_telemetry_identity.py; the
sojourn percentiles against refsim: tests/test_torch_telemetry_percentiles.py;
grids and sweeps: tests/test_torch_telemetry_grid.py.
"""
import dataclasses
import inspect
import json
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_sim_helpers import one_thread
from repro.core import simulator as jsim
from repro.telemetry import collectors as jtlm
from repro.telemetry import export as jexp
from repro.telemetry import hist as jhist
from repro_torch.core import simulator as tsim
from repro_torch.core.cluster import Cluster, Rates
from repro_torch.telemetry import collectors as ttlm
from repro_torch.telemetry import export as texp
from repro_torch.telemetry import hist as thist

ROOT = Path(__file__).resolve().parents[1]
CL, R = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
TCFG = ttlm.TelemetryConfig()
RTOL = 1e-6


def _same(a, b) -> bool:
    return torch.equal(a, b) or bool(a.isnan().all() and b.isnan().all())


# ---------------------------------------------------------------------------
# hist
# ---------------------------------------------------------------------------


def test_bin_index_equals_the_reference_exactly():
    rng = np.random.default_rng(0)
    edges = (np.exp2(np.arange(1, 128) / 8) - 1).astype(np.float32)
    near = (edges.view(np.int32)[:, None] + np.arange(-5000, 5001)[None, :]
            ).astype(np.int32).view(np.float32).ravel()
    v = np.concatenate([(rng.random(200_000) * 70_000).astype(np.float32),
                        (rng.random(200_000) * 20).astype(np.float32),
                        np.arange(0, 70_000, dtype=np.float32), near,
                        -rng.random(100).astype(np.float32),
                        np.array([1e9, 65535, 65536], np.float32)])
    want = np.asarray(jhist.bin_index(jnp.asarray(v)))
    got = thist.bin_index(torch.from_numpy(v))
    assert got.dtype == torch.int64
    moved = int((got.numpy() != want).sum())
    assert moved == 0, moved
    ints = torch.arange(0, 4000, dtype=torch.int32)       # queue lengths as ints
    np.testing.assert_array_equal(thist.bin_index(ints).numpy(),
                                  np.asarray(jhist.bin_index(jnp.arange(4000))))


def test_histogram_helpers_equal_the_reference():
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(thist.bin_edges(), jhist.bin_edges())
    np.testing.assert_array_equal(thist.bin_edges(40, 4), jhist.bin_edges(40, 4))
    vals = rng.exponential(30.0, 5000)
    np.testing.assert_array_equal(thist.np_hist(vals), jhist.np_hist(vals))
    h = thist.np_hist(vals)
    assert thist.percentiles(h, (50, 95, 99)) == jhist.percentiles(h, (50, 95, 99))
    assert np.isnan(thist.percentiles(np.zeros(128), (50,))[0])
    assert (thist.N_BINS, thist.BINS_PER_OCTAVE) == (jhist.N_BINS, jhist.BINS_PER_OCTAVE)


# ---------------------------------------------------------------------------
# collectors
# ---------------------------------------------------------------------------


def test_config_and_channels_equal_the_reference():
    got = [(f.name, f.default) for f in dataclasses.fields(ttlm.TelemetryConfig)]
    want = [(f.name, f.default) for f in dataclasses.fields(jtlm.TelemetryConfig)]
    assert got == want
    assert ttlm.WINDOW_SUMS == jtlm.WINDOW_SUMS and ttlm.WINDOW_MAXES == jtlm.WINDOW_MAXES
    assert ttlm.Telemetry._fields == jtlm.Telemetry._fields
    for T in (1, 63, 64, 65, 5000):
        assert TCFG.window_len(T) == jtlm.TelemetryConfig().window_len(T)
    for family, M in (("bp", 7), ("sq", 7), ("fcfs", 7)):
        t = ttlm.zero_telemetry(TCFG, M, family, cells=3)
        j = jtlm.zero_telemetry(jtlm.TelemetryConfig(), M, family)
        for name, a, b in zip(ttlm.Telemetry._fields, t, j):
            assert (a is None) == (b is None), (family, name)
            if a is not None:
                assert tuple(a.shape) == (3,) + tuple(np.shape(b)), (family, name)
                np.testing.assert_array_equal(a[1].numpy(), np.asarray(b))


@pytest.mark.parametrize("seed", range(3))
def test_probe_stats_equal_the_reference(seed):
    """Three cells of [A, M] scores with ties, +inf entries and invalid
    decisions: each cell's sums equal the reference's on that cell."""
    rng = np.random.default_rng(seed)
    N, A, M = 3, 9, 30
    full = rng.integers(0, 6, (N, A, M)).astype(np.float32) * np.float32(0.37)
    full[rng.random((N, A, M)) < 0.1] = np.inf
    pick = rng.integers(0, M, (N, A))
    chosen = np.take_along_axis(full, pick[..., None], -1)[..., 0]
    valid = rng.random((N, A)) < 0.8
    elig = rng.random((N, A, M)) < 0.7
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    got_min = ttlm.probe_stats_min(t(full), t(chosen), t(valid))
    got_max = ttlm.probe_stats_max(t(full), t(chosen), t(valid), t(elig))
    for n in range(N):
        for got, want in (
                (got_min, jtlm.probe_stats_min(full[n], chosen[n], valid[n])),
                (got_max, jtlm.probe_stats_max(full[n], chosen[n], valid[n], elig[n]))):
            assert float(got[0][n]) == float(want[0])                 # rank
            np.testing.assert_allclose(float(got[1][n]), float(want[1]), rtol=RTOL)
            assert float(got[2][n]) == float(want[2])                 # decisions


@pytest.mark.parametrize("inv_kind", ["[3]", "[M,3]", "[N,M,3]"])
def test_route_commit_wseq_folds_each_cells_commits_in_arrival_order(inv_kind):
    """The batched probe's oracle rows, [N, B, M]: W0 in the kernel's
    pinned order plus each earlier commit added one at a time, in arrival
    order, to the bit (a float32 left fold in numpy); servers picked three
    and more times in a batch, non-integer and dead (+inf) rates; each
    cell within 1e-6 of the reference's ``route_commit_wseq``."""
    from repro.kernels import ref as jref
    from repro_torch.kernels.ref import route_commit_wseq

    rng = np.random.default_rng(7)
    N, B, M = 3, 17, 12
    Q = rng.integers(0, 9, (N, M, 3)).astype(np.int32)
    shape = {"[3]": (3,), "[M,3]": (M, 3), "[N,M,3]": (N, M, 3)}[inv_kind]
    inv = rng.uniform(0.3, 7.0, shape).astype(np.float32)
    if inv.ndim > 1:
        inv[..., 2, 1] = np.inf
    sel = rng.integers(0, 4, (N, B)).astype(np.int32)         # many repeats
    scls = rng.integers(0, 4, (N, B)).astype(np.int32)        # class 3 commits 0
    valid = rng.random((N, B)) < 0.8
    got = route_commit_wseq(*(torch.from_numpy(x) for x in (Q, sel, scls, valid, inv)))
    assert got.shape == (N, B, M)
    f32 = np.float32
    for n in range(N):
        cell_inv = inv[n] if inv.ndim == 3 else inv
        fin = np.where(np.isfinite(cell_inv), cell_inv, f32(0)).astype(f32)
        fin = np.broadcast_to(fin, (M, 3))
        x = (Q[n].astype(f32) * fin).astype(f32)
        w0 = ((x[:, 0] + x[:, 1]).astype(f32) + x[:, 2]).astype(f32)
        dw = np.zeros(M, f32)
        for b in range(B):
            np.testing.assert_array_equal(got[n, b].numpy(), (w0 + dw).astype(f32),
                                          err_msg=f"cell {n} arrival {b}")
            if valid[n, b] and scls[n, b] < 3:
                dw[sel[n, b]] = f32(dw[sel[n, b]] + fin[sel[n, b], scls[n, b]])
        want = jref.route_commit_wseq(jnp.asarray(Q[n]), jnp.asarray(sel[n]),
                                      jnp.asarray(scls[n]), jnp.asarray(valid[n]),
                                      jnp.asarray(cell_inv))
        np.testing.assert_allclose(got[n].numpy(), np.asarray(want), rtol=RTOL)
    assert int((np.bincount(sel[0], minlength=4) >= 3).sum()) > 0


def test_ring_pop_skips_the_rank_only_where_it_is_zero():
    """BP pops queue m*3 + pick for server m: distinct ids, so the pairwise
    rank is 0 and ``distinct=True`` leaves the same state; the SQ family's
    steal conflicts share ids and keep the compare."""
    rng = np.random.default_rng(3)
    N, M, cap = 4, 25, 8
    cfg = ttlm.TelemetryConfig(ring_cap=cap)
    base = ttlm.zero_telemetry(cfg, M, "bp", cells=N)
    base.tail.copy_(torch.from_numpy(rng.integers(0, 6, base.tail.shape).astype(np.int32)))
    base.tail[:, -1] = 0
    base.ring.copy_(torch.from_numpy(rng.integers(0, 99, base.ring.shape).astype(np.int32)))
    m = torch.arange(M)
    for _ in range(5):
        qid = m * 3 + torch.from_numpy(rng.integers(0, 3, (N, M)))
        pop = torch.from_numpy(rng.random((N, M)) < 0.6)
        a = ttlm.Telemetry(*(None if x is None else x.clone() for x in base))
        b = ttlm.Telemetry(*(None if x is None else x.clone() for x in base))
        ttlm.ring_pop(a, cfg, qid, pop, m.expand(N, M))
        ttlm.ring_pop(b, cfg, qid, pop, m.expand(N, M), distinct=True)
        for name, x, y in zip(ttlm.Telemetry._fields, a, b):
            assert torch.equal(x, y), name
        base = a


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def _run_one(algo, T=1200, warmup=300, load=0.7, seed=2, mode="batched", **kw):
    cfg = tsim.SimConfig(T=T, warmup=warmup, route_mode=mode)
    with one_thread():
        return tsim.simulate_with_telemetry(algo, CL, R, load, seed, cfg,
                                            device="cpu", **kw)


def _numpy_tele(tele):
    """The port's Telemetry as the reference's, through the adapter."""
    return jtlm.Telemetry(*texp.to_numpy(tele))


@pytest.mark.parametrize("algo", ["balanced_pandas_pod", "jsq_maxweight_pod", "fcfs"])
def test_export_equals_the_reference_on_the_same_arrays(algo):
    cfg_t = TCFG
    cfg_j = jtlm.TelemetryConfig()
    T, warmup = 1200, 300
    _, tele = _run_one(algo, T, warmup)
    jt = _numpy_tele(tele)
    assert texp.window_records(tele, cfg_t, T) == jexp.window_records(jt, cfg_j, T)
    assert texp.probe_summary(tele) == jexp.probe_summary(jt)
    a, b = texp.sojourn_percentiles(tele, cfg_t), jexp.sojourn_percentiles(jt, cfg_j)
    assert json.dumps(a) == json.dumps(b)
    for w in (0, warmup, 700):
        d1, d2 = texp.windowed_drift(tele, cfg_t, T, w), jexp.windowed_drift(jt, cfg_j, T, w)
        assert d1 == d2 or (np.isnan(d1) and np.isnan(d2))
        assert json.dumps(texp.tail_stats(tele, cfg_t, T, w)) == \
            json.dumps(jexp.tail_stats(jt, cfg_j, T, w))
    for pol in (texp.WarmupPolicy(), texp.WarmupPolicy(threshold=1.0001, chunk_windows=1)):
        jpol = jexp.WarmupPolicy(**dataclasses.asdict(pol))
        r1 = texp.auto_extend_warmup(tele, cfg_t, T, warmup, pol)
        r2 = jexp.auto_extend_warmup(jt, cfg_j, T, warmup, jpol)
        assert json.dumps(r1._asdict()) == json.dumps(r2._asdict())
        assert r1.fields() == r2.fields()
    man = texp.run_manifest(algo=algo, T=T)
    ev_t = texp.to_events(tele, cfg_t, T, warmup, manifest=man, per_window_hists=True)
    ev_j = jexp.to_events(jt, cfg_j, T, warmup, manifest=jexp.run_manifest(algo=algo, T=T),
                          per_window_hists=True)
    assert [sorted(e) for e in ev_t] == [sorted(e) for e in ev_j]
    assert json.dumps(ev_t) == json.dumps(ev_j)
    assert texp.validate_events(ev_t) == [] == jexp.validate_events(ev_j)
    assert texp.validate_events([]) == jexp.validate_events([])
    cells = [("a", 0.0), ("b", 0.01)]
    assert texp.format_clip_warning(cells) == jexp.format_clip_warning(cells)
    assert texp.SCHEMA_VERSION == jexp.SCHEMA_VERSION


def test_jsonl_passes_the_reference_validator(tmp_path):
    """scripts/validate_telemetry.py, the reference's validator, run
    unchanged as a subprocess over the port's JSONL of two runs."""
    path = tmp_path / "events.jsonl"
    for algo in ("balanced_pandas", "jsq_maxweight_pod"):
        _, tele = _run_one(algo, 600, 150)
        texp.write_jsonl(str(path), texp.to_events(
            tele, TCFG, 600, 150, manifest=texp.run_manifest(algo=algo)))
    assert len(texp.read_jsonl(str(path))) == len(jexp.read_jsonl(str(path)))
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "validate_telemetry.py"),
                          str(path)], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stdout + out.stderr
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps({"event": "window"}) + "\n")
    out = subprocess.run([sys.executable, str(ROOT / "scripts" / "validate_telemetry.py"),
                          str(bad)], capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 1


def test_to_numpy_moves_every_leaf_to_the_host():
    """Tensor leaves become numpy arrays of the same values and shapes,
    None stays None, and numpy leaves pass through."""
    tele = ttlm.zero_telemetry(TCFG, 5, "sq", cells=2 * 3 * 4)
    tele.win[:, 0, 0] = torch.arange(24, dtype=torch.float32)
    g = texp.to_numpy(tele)
    for name, a, b in zip(ttlm.Telemetry._fields, tele, g):
        assert (a is None) == (b is None), name
        if a is not None:
            assert isinstance(b, np.ndarray), name
            np.testing.assert_array_equal(b, a.numpy(), err_msg=name)
    assert g.ring.shape == (24, 6, TCFG.ring_cap)
    again = texp.to_numpy(g)
    for a, b in zip(g, again):
        assert a is None and b is None or np.array_equal(a, b)
    assert texp.cell_view(g, 23).win[0, 0] == 23


# ---------------------------------------------------------------------------
# contracts
# ---------------------------------------------------------------------------


def test_auto_warmup_equals_telemetry_run_and_the_reference_report():
    cfg = tsim.SimConfig(T=1200, warmup=300, route_mode="batched")
    with one_thread():
        res, tele = tsim.simulate_with_telemetry("balanced_pandas_pod", CL, R, 0.9, 4,
                                                 cfg, device="cpu")
        res2, tele2, rep = tsim.simulate_auto_warmup("balanced_pandas_pod", CL, R, 0.9,
                                                     4, cfg, device="cpu")
    for name, a, b in zip(res._fields, res, res2):
        assert _same(a, b), name
    for a, b in zip(tele, tele2):
        assert torch.equal(a, b)
    want = jexp.auto_extend_warmup(_numpy_tele(tele), jtlm.TelemetryConfig(), cfg.T,
                                   cfg.warmup, jexp.WarmupPolicy())
    assert json.dumps(rep._asdict()) == json.dumps(want._asdict())


@pytest.mark.parametrize("name", ["simulate_with_telemetry", "simulate_auto_warmup",
                                  "simulate_grid_with_telemetry"])
def test_entry_points_take_the_reference_arguments(name):
    """The reference's parameters, names, order and defaults (telemetry's
    by field); the port adds keyword-only ones after them."""
    ours = inspect.signature(getattr(tsim, name)).parameters
    theirs = inspect.signature(getattr(jsim, name)).parameters
    pos = [p for p in ours.values() if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert [p.name for p in pos] == list(theirs)
    for p in pos:
        d, e = p.default, theirs[p.name].default
        if dataclasses.is_dataclass(d):
            assert dataclasses.asdict(d) == dataclasses.asdict(e)
        elif p.name not in ("cfg",):
            assert d == e or (d is None and e is None), p.name
    assert {p.name for p in ours.values() if p.kind == p.KEYWORD_ONLY} <= {"device", "draws"}
