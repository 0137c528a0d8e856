"""The ``sweep`` cell on the CPU at a tiny size: the driver's call against
the plain reference of heterogeneous servers (``reference_hetero``) in
every scenario, the bfloat16 control, the reference's own realization
against the program's, the replayed arrivals, the matrix roofline bound by
hand, and the two readers the cell adds."""
import json
import subprocess
import sys

import numpy as np
import pytest
import torch

from portbench import bounds, harness, reference_hetero
from portbench import trace as tr
from portbench._testing import driver, tiny
from portbench.metrics import _roofline_matrix

WORKLOAD = "sweep-m500-registry-bppod"
T = 160                 # every window of the 11 scenarios opens and closes
SEED = 2**31 + 7


def _tiny():
    """The cell at 40 servers, 2 loads x 2 seeds and T slots, its service
    rates four times the configuration's (the simulator's default ``Rates``),
    so that in so short a run every scenario's events change answers."""
    config, traffic = tiny(WORKLOAD, T=T)
    config["rates"] = [0.04, 0.02, 0.008]
    return config, traffic


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", name)


@pytest.fixture(scope="module")
def swept():
    """One tiny timed call of the cell on the CPU and its comparisons."""
    torch.set_num_threads(1)
    config, traffic = _tiny()
    run = driver(traffic).prepare(config, traffic, seed=SEED, device="cpu")
    run.call(0)
    rng = lambda: np.random.default_rng(0)
    return {"run": run, "gaps": run.check(rng())["result_gap"],
            "low": run.check(rng(), fdt=torch.bfloat16)["result_gap"]}


def _scenario_cells(run, name):
    per = run.n_seeds * len(run.loads)
    s = run.names.index(name)
    return slice(s * per, (s + 1) * per)


@pytest.mark.parametrize("name", tiny(WORKLOAD)[0]["scenarios"])
def test_each_scenario_equals_the_reference(swept, name):
    run = swept["run"]
    cells = _scenario_cells(run, name)
    assert swept["gaps"][cells] == [0.0] * (cells.stop - cells.start)
    # the port's own answers: every cell differs from the others, and the
    # scenario's events change some cell's from the homogeneous fleet's
    got = run.results[0]["mean_completion_slots"].reshape(run.cells)
    assert len(set(got[cells].tolist())) == cells.stop - cells.start
    if name != "uniform":
        assert (got[cells] != got[_scenario_cells(run, "uniform")]).any()


def test_bfloat16_control_fails(swept):
    limit = driver(tiny(WORKLOAD)[1]).LIMITS["result_gap"]
    assert max(swept["low"]) > limit


@pytest.mark.parametrize("M,K,T_", [(40, 4, T), (500, 10, 5000)])
def test_the_frozen_realization_is_the_programs(M, K, T_):
    from repro_torch import scenarios
    from repro_torch.core import simulator as sim
    config = json.loads((harness.HERE / "configs" / "hetero-m500-k10-registry.json").read_text())
    names, loads, rates = config["scenarios"], config["loads"], tuple(config["rates"])
    cluster = sim.Cluster(M, K)
    pad = scenarios.canonical_pad(cluster)
    _, stacked, lam, a_max = sim.sweep_grid(cluster, sim.Rates(*rates), sim.SimConfig(T=T_),
                                            loads, scenarios=names, pad=pad, device="cpu")
    _, caps = scenarios.stack_scenarios(names, cluster, sim.Rates(*rates), T_, pad, device="cpu")
    specs = [scenarios.get_scenario(n) for n in names]
    want = reference_hetero.realize(specs, M, K, rates, T_, pad.n_windows)
    for s, r in enumerate(want):
        for leaf in ("lam_shape", "base_speed", "win_start", "win_end", "win_mult"):
            got = getattr(stacked, leaf)[s].numpy()
            assert got.dtype == getattr(r, leaf).dtype and np.array_equal(got, getattr(r, leaf)), \
                (names[s], leaf)
        assert r.lam_cap == caps[s]
    # the reference draws as uniform placement with unit sizes does
    assert (stacked.placement_on == 0).all() and (stacked.size_sigma == 0).all()
    assert reference_hetero.a_max_for(want, loads) == a_max
    lams, _, rows = reference_hetero.cells(want, loads, [0])
    assert lams == lam.flatten().tolist() and rows == [s for s in range(len(names))
                                                       for _ in loads]
    if M == 500:
        assert a_max == 33 and pad == (8, 2000, 3)


def test_the_replayed_arrivals_are_the_routed_ones(swept):
    run = swept["run"]
    work = run.route_commit_work(0)
    live = work["live"]
    assert work["matrix"] and work["kernel"] == "route_commit_pod" and work["C"] == 11
    assert live.shape == (run.T, run.cells) and work["B"] == run.a_max
    assert 0 < live.max() <= run.a_max and (live == 0).any()
    routed = run.results[0]["route_decisions"].reshape(run.cells)
    assert live[run.warmup:].sum(axis=0).tolist() == routed.tolist()


def test_matrix_roofline_bound_by_hand():
    # one cell, M=500, B=33, C=11, 33 live arrivals: queues in and out 12 000,
    # workloads 2 000, the cell's [500, 3] inverse rates 6 000, mask 33, outputs
    # 396, candidates 1 815, classes 1 452
    assert _roofline_matrix.route_commit_pod(500, 33, 11, [[33]]) == pytest.approx(
        23696 / 3.35e12)
    # against the [3] operand's bound: 12 M bytes more a routing cell, 12 less a slot
    live = [[5, 0, 7], [0, 0, 0], [33, 1, 2]]
    extra = (2 * 12 * 500 - 12 + 3 * 12 * 500 - 12) / 3.35e12
    assert _roofline_matrix.route_commit_pod(500, 33, 11, live) == pytest.approx(
        bounds.route_commit(500, 33, 11, live) + extra)
    assert _roofline_matrix.route_commit_pod(500, 33, 11, [[0, 0]]) == 0.0


def _trace(host=(), device=(), matrix=True):
    work = {"kernel": "route_commit_pod", "matrix": matrix, "M": 500, "B": 33, "C": 11,
            "live": [[5, 3], [0, 2]]}
    return tr.Trace((0.0, 1000.0), sorted(device, key=lambda e: e[1]),
                    sorted(host, key=lambda e: e[1]), 2, work)


def test_the_readers_on_known_traces():
    device = [("route_commit_pod_kernel", 100.0, 110.0), ("k", 300.0, 400.0),
              ("route_commit_pod_kernel", 600.0, 615.0)]
    host = [("sim.scenario.speed", 50.0, 150.0), ("sim.scenario.speed", 450.0, 500.0),
            ("sim.step.schedule", 150.0, 300.0)]
    t = _trace(host, device)
    # speed spans [50, 150] and [450, 500] against the gaps: 50 + 40 + 50
    assert _reader("scenario_idle_share.sim").read(t) == pytest.approx(140 / 1000)
    least = _roofline_matrix.route_commit_pod(500, 33, 11, [[5, 3], [0, 2]])
    assert _reader("route_commit_pod_matrix_roofline.sim").read(t) == pytest.approx(
        100 * least / 25e-6)


def test_the_readers_read_nothing_without_their_span_or_kernel():
    speed, roof = _reader("scenario_idle_share.sim"), _reader("route_commit_pod_matrix_roofline.sim")
    kernel = [("route_commit_pod_kernel", 100.0, 110.0)]
    assert speed.read(_trace([("sim.step.schedule", 0.0, 900.0)], kernel)) is None
    assert speed.read(_trace([("sim.scenario.speed", 0.0, 900.0)], [])) is None
    assert roof.read(_trace(device=[("k", 100.0, 110.0)])) is None
    assert roof.read(_trace(device=kernel, matrix=False)) is None
    assert roof.read(tr.Trace((0.0, 1.0), kernel, [], 1, {"kernel": "route_commit_pod"})) is None
    from repro_torch.spans import SPANS
    assert set(speed.SPEED) <= set(SPANS)


def test_the_speed_span_fires_once_a_slot():
    from repro_torch.core import simulator as sim
    torch.set_num_threads(1)
    cfg = sim.SimConfig(T=40, warmup=10, route_mode="batched")
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function(tr.SPAN):
            sim.simulate_sweep("balanced_pandas_pod", sim.Cluster(40, 4), sim.Rates(), [0.9], 1,
                               cfg, scenarios=["uniform", "rack_outage"], device="cpu")
    names = [n for n, _, _ in tr.from_profile(prof, 40, {}).host]
    assert names.count("sim.scenario.speed") == 40 == names.count("sim.step.route")


def test_no_jax_in_a_sweep_run():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from portbench import harness\n"
            "from portbench._testing import tiny\n"
            f"c, traffic = tiny({WORKLOAD!r}, T=20)\n"
            "c['loads'], traffic['n_seeds'] = [0.9], 1\n"
            f"d = harness.find(harness.load_spec(), {WORKLOAD!r})[3].prepare(c, traffic, 1, 'cpu')\n"
            "print(harness.banned_modules(), 'repro_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]


@pytest.mark.gpu
def test_the_cell_tiny_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels.invrates import LAUNCHES, MATRIX_LAUNCHES, reset_launch_counts
    config, traffic = _tiny()
    run = driver(traffic).prepare(config, traffic, seed=SEED, device="cuda:0")
    reset_launch_counts()
    run.call(0)
    assert MATRIX_LAUNCHES["route_commit_pod"] == T == LAUNCHES["route_commit_pod"]
    assert run.check(np.random.default_rng(0))["result_gap"] == [0.0] * run.cells
    low = run.check(np.random.default_rng(0), fdt=torch.bfloat16)["result_gap"]
    assert max(low) > 0.0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tr.SPAN):
            run.call(1)
    t = tr.from_profile(prof, run.slot_steps(1), run.route_commit_work(1))
    assert _reader("scenario_idle_share.sim").read(t) is not None
    assert 0 < _reader("route_commit_pod_matrix_roofline.sim").read(t) < 100
