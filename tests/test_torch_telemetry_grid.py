"""Telemetry over the grid's cell axis, on the CPU.

Every cell of ``simulate_grid_with_telemetry`` (2 seeds x 2 loads) equals
its looped ``simulate_with_telemetry`` run given the grid's a_max, every
Telemetry leaf to the bit, for every algorithm; every cell of
``simulate_sweep(telemetry=...)`` equals its looped
``simulate_grid_with_telemetry`` on its scenario with the sweep's pad and
a_max, and the sweep split over two devices equals the one-device sweep;
a grid with telemetry is bit-identical to one without.  The leaves come in
the reference's layout, and the port's ``aggregate`` / ``cell_view`` equal
the reference's on the same arrays.
"""
import numpy as np
import pytest
import torch

from _torch_sim_helpers import one_thread
from repro.core import cluster as jcl
from repro.core import simulator as jsim
from repro.telemetry import collectors as jtlm
from repro.telemetry import export as jexp
from repro_torch.core import simulator as tsim
from repro_torch.core.cluster import Cluster, Rates
from repro_torch.scenarios import build as tbuild
from repro_torch.telemetry import collectors as ttlm
from repro_torch.telemetry import export as texp

M, K = 20, 4
CL, R = Cluster(M=M, K=K), Rates(0.1, 0.05, 0.02)
LOADS = (0.45, 0.85)
TCFG = ttlm.TelemetryConfig(n_windows=8)
ALGOS = tsim.ALGORITHMS + ("balanced_pandas_randomtie",)


def _same(a, b) -> bool:
    return torch.equal(a, b) or bool(a.isnan().all() and b.isnan().all())


def _assert_tele_equal(a, b, label):
    for name, x, y in zip(ttlm.Telemetry._fields, a, b):
        assert (x is None) == (y is None), (label, name)
        if x is not None:
            assert torch.equal(x, y), (label, name)


@pytest.mark.parametrize("algo", ALGOS)
def test_grid_cells_equal_looped_telemetry_runs(algo):
    cfg = tsim.SimConfig(T=240, warmup=60, s_max=16, route_mode="batched")
    with one_thread():
        res, tele = tsim.simulate_grid_with_telemetry(algo, CL, R, LOADS, 2, cfg,
                                                      seed0=3, telemetry=TCFG,
                                                      device="cpu")
        plain = tsim.simulate_grid(algo, CL, R, LOADS, 2, cfg, seed0=3, device="cpu")
        for name, a, b in zip(res._fields, res, plain):
            assert _same(a, b), name
        scen, cap = tbuild.realize(None, CL, R, cfg.T, device="cpu")
        a_max = cfg.resolve_a_max(float(np.float32(max(LOADS) * cap)))
        for k in range(2):
            for l, load in enumerate(LOADS):
                one, t1 = tsim.simulate_with_telemetry(
                    algo, CL, R, load, 3 + k, cfg, a_max=a_max, telemetry=TCFG,
                    device="cpu")
                for name, a, b in zip(one._fields, one, res):
                    assert _same(a, b[k, l] if b.ndim >= 2 else b), (k, l, name)
                cell = ttlm.Telemetry(*(None if x is None else x[k, l] for x in tele))
                _assert_tele_equal(cell, t1, (k, l))


def test_grid_sequential_mode_cells_equal_looped_runs():
    cfg = tsim.SimConfig(T=200, warmup=50, route_mode="sequential")
    with one_thread():
        _, tele = tsim.simulate_grid_with_telemetry("balanced_pandas_pod", CL, R, LOADS,
                                                    2, cfg, telemetry=TCFG, device="cpu")
        scen, cap = tbuild.realize(None, CL, R, cfg.T, device="cpu")
        a_max = cfg.resolve_a_max(float(np.float32(max(LOADS) * cap)))
        _, t1 = tsim.simulate_with_telemetry("balanced_pandas_pod", CL, R, LOADS[1], 1,
                                             cfg, a_max=a_max, telemetry=TCFG,
                                             device="cpu")
    _assert_tele_equal(ttlm.Telemetry(*(None if x is None else x[1, 1] for x in tele)),
                       t1, "seed 1, load 0.85")


@pytest.mark.parametrize("algo", ["balanced_pandas_pod", "jsq_maxweight_pod", "fcfs"])
def test_sweep_cells_equal_looped_telemetry_grids(algo):
    names = ["uniform", "slow_rack", "zipf_hotspot"]
    pad = tbuild.canonical_pad(CL)
    cfg = tsim.SimConfig(T=160, warmup=40, s_max=16, route_mode="batched")
    with one_thread():
        a_max = tsim.sweep_grid(CL, R, cfg, LOADS, names, pad, device="cpu")[3]
        labels, res, tele = tsim.simulate_sweep(algo, CL, R, LOADS, 2, cfg, seed0=5,
                                                scenarios=names, pad=pad,
                                                telemetry=TCFG, device="cpu")
        _, res2, tele2 = tsim.simulate_sweep(algo, CL, R, LOADS, 2, cfg, seed0=5,
                                             scenarios=names, pad=pad, telemetry=TCFG,
                                             devices=["cpu", "cpu"])
        _, plain, none = tsim.simulate_sweep(algo, CL, R, LOADS, 2, cfg, seed0=5,
                                             scenarios=names, pad=pad, device="cpu")
        assert labels == names and none is None
        assert tele.win.shape == (3, 2, 2, TCFG.n_windows, len(ttlm.WINDOW_SUMS))
        _assert_tele_equal(tele, tele2, "split over two devices")
        for name, a, b, c in zip(res._fields, res, res2, plain):
            assert _same(a, b) and _same(a, c), name
        for s, name in enumerate(names):
            _, gtele = tsim.simulate_grid_with_telemetry(
                algo, CL, R, LOADS, 2, cfg, seed0=5, scenario=name, pad=pad,
                a_max=a_max, telemetry=TCFG, device="cpu")
            _assert_tele_equal(ttlm.Telemetry(*(None if x is None else x[s] for x in tele)),
                               gtele, name)


def test_grid_layout_and_reductions_equal_the_reference():
    """The port's grid telemetry has the reference's leaf shapes, and the
    reference's aggregate / cell_view on its arrays give what the port's
    give."""
    cfg_t = tsim.SimConfig(T=200, warmup=50, route_mode="batched")
    cfg_j = jsim.SimConfig(T=200, warmup=50, route_mode="batched")
    with one_thread():
        _, tele = tsim.simulate_grid_with_telemetry("balanced_pandas", CL, R, LOADS, 3,
                                                    cfg_t, telemetry=TCFG, device="cpu")
    _, jtele = jsim.simulate_grid_with_telemetry(
        "balanced_pandas", jcl.Cluster(M=M, K=K), jcl.Rates(0.1, 0.05, 0.02), LOADS, 3,
        cfg_j, telemetry=jtlm.TelemetryConfig(n_windows=8))
    for name, a, b in zip(ttlm.Telemetry._fields, tele, jtele):
        assert tuple(a.shape) == tuple(np.shape(b)), name
    host = jtlm.Telemetry(*texp.to_numpy(tele))
    for got, want in ((texp.aggregate(tele), jexp.aggregate(host)),
                      (texp.cell_view(tele, (2, 1)), jexp.cell_view(host, (2, 1))),
                      (texp.aggregate(texp.cell_view(tele, (slice(None), 0))),
                       jexp.aggregate(jexp.cell_view(host, (slice(None), 0))))):
        for name, a, b in zip(ttlm.Telemetry._fields, got, want):
            assert (a is None) == (b is None), name
            if a is not None:
                np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=name)
