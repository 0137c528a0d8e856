"""The port's grid entry points (``simulate_grid``, ``sweep_grid``,
``simulate_sweep``) and ``scenarios.stack_scenarios``, against the JAX
reference and against the port's own looped runs.

The stack and the sweep's axes equal the reference's bit for bit.  Every
grid cell equals the looped ``simulate`` with the grid's a_max, and every
sweep cell the looped ``simulate_grid``, bit for bit, for every algorithm
in both route modes: a cell draws from a generator seeded ``seed0 + k``,
as the looped run does, and the batched slot step computes every cell as
the one-cell step would.  A slot of N cells issues as many torch ops as a
slot of one.
"""
import dataclasses
import inspect

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_sim_helpers import one_thread
from repro.core import cluster as jcl
from repro.core import simulator as jsim
from repro.scenarios import build as jbuild
from repro_torch.core import cluster as tcl
from repro_torch.core import simulator as tsim
from repro_torch.scenarios import build as tbuild

M, K = 20, 4
RATES = (0.1, 0.05, 0.02)
CL_J, CL_T = jcl.Cluster(M=M, K=K), tcl.Cluster(M=M, K=K)
R_J, R_T = jcl.Rates(*RATES), tcl.Rates(*RATES)
# the shapes of tests/test_sweep.py's one-program sweep
CFG = dict(T=112, warmup=32, s_max=16)
LOADS = (0.45, 0.85)
PAD = tbuild.canonical_pad(CL_T)          # the port's registry, production_day too
NAMES = ["uniform", "slow_rack", "zipf_hotspot"]
ALGOS = tsim.ALGORITHMS + ("balanced_pandas_randomtie",)


def _same(a, b) -> bool:
    return torch.equal(a, b) or bool(a.isnan().all() and b.isnan().all())


def _assert_cell(result, index, want, label):
    for name, a, b in zip(want._fields, result, want):
        got = a[index] if a.ndim > b.ndim else a
        assert _same(got, b), (label, name, got, b)


# ---------------------------------------------------------------------------
# stacking and the sweep's axes
# ---------------------------------------------------------------------------


def test_stack_scenarios_equals_the_reference():
    """Leaves and capacity edges of the stack equal the reference's bit for
    bit (the LP's edge of zipf_hotspot too), each row equals the port's own
    padded realization, and the caps are float64 [S]."""
    stacked, caps = tbuild.stack_scenarios(NAMES, CL_T, R_T, CFG["T"], PAD, device="cpu")
    jstacked, jcaps = jbuild.stack_scenarios(NAMES, CL_J, R_J, CFG["T"],
                                             pad=jbuild.ScenarioPad(*PAD))
    assert caps.dtype == np.float64 and caps.shape == (3,)
    np.testing.assert_array_equal(caps, np.asarray(jcaps))
    for name, a in zip(tbuild.ScenarioData._fields, stacked):
        b = getattr(jstacked, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.shape[0] == 3, name
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    for s, n in enumerate(NAMES):
        one, cap = tbuild.realize(n, CL_T, R_T, CFG["T"], PAD, device="cpu")
        assert cap == caps[s]
        for name, a, b in zip(one._fields, tbuild.scenario_row(stacked, s), one):
            assert torch.equal(a, b), (n, name)


def test_stack_scenarios_rejects_an_undersized_pad_and_an_empty_list():
    small = PAD._replace(n_windows=1)      # straggler_wave needs 4
    with pytest.raises(ValueError, match="pad"):
        tbuild.stack_scenarios(["uniform", "straggler_wave"], CL_T, R_T, CFG["T"],
                               small, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tbuild.stack_scenarios([], CL_T, R_T, CFG["T"], device="cpu")


class _CountOps(TorchDispatchMode):
    """Counts the torch operators a block of code dispatches, but for those
    inside ``route_commit`` (whose plain version loops over the cells on
    the CPU, where the card launches one kernel): those calls are counted
    in ``routes``."""

    def __init__(self, monkeypatch=None):
        super().__init__()
        self.n = self.routes = 0
        self.paused = False
        if monkeypatch is not None:
            real = tsim.route_commit

            def route_commit(*args, **kw):
                self.routes += 1
                self.paused = True
                try:
                    return real(*args, **kw)
                finally:
                    self.paused = False
            monkeypatch.setattr(tsim, "route_commit", route_commit)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += not self.paused
        return func(*args, **(kwargs or {}))


def test_speed_at_over_the_stack_is_every_row_in_the_ops_of_one():
    """speed_at over a stack of S scenarios is [S, M, 3], each row equal to
    speed_at of that scenario to the bit at every slot (the windows of
    rack_outage and straggler_wave open and close inside the run), in as
    many torch ops as one scenario takes; placement_epoch_at gives [S]."""
    names = ["uniform", "rack_outage", "straggler_wave", "outage_storm"]
    T = 400
    stacked, _ = tbuild.stack_scenarios(names, CL_T, R_T, T, PAD, device="cpu")
    rows = [tbuild.realize(n, CL_T, R_T, T, PAD, device="cpu")[0] for n in names]
    for t in range(T):
        got = tbuild.speed_at(stacked, t)
        assert got.shape == (4, M, 3)
        for s, row in enumerate(rows):
            assert torch.equal(got[s], tbuild.speed_at(row, t)), (names[s], t)
    counts = []
    for scen in (stacked, rows[1]):
        with _CountOps() as c:
            tbuild.speed_at(scen, 200)
        counts.append(c.n)
    assert counts[0] == counts[1], counts
    assert tuple(tbuild.placement_epoch_at(stacked, 7).shape) == (4,)


def test_sweep_grid_equals_the_reference():
    """Labels, the [S, L] float32 arrival rates (the LP's edge included)
    and the shared a_max, sized from each scenario's peak shape."""
    names = ["uniform", "mmpp_bursty", "flash_crowd", "zipf_hotspot"]
    cfg_j, cfg_t = jsim.SimConfig(**CFG), tsim.SimConfig(**CFG)
    labels, stacked, lam, a_max = tsim.sweep_grid(CL_T, R_T, cfg_t, LOADS, names, PAD,
                                                  device="cpu")
    jlabels, _, jlam, ja_max = jsim.sweep_grid(CL_J, R_J, cfg_j, LOADS, names,
                                               jbuild.ScenarioPad(*PAD))
    assert labels == jlabels == names
    assert lam.dtype == torch.float32 and lam.shape == (4, 2)
    np.testing.assert_array_equal(lam.numpy(), np.asarray(jlam))
    assert a_max == ja_max
    # the default is the port's whole registry
    labels, stacked, lam, _ = tsim.sweep_grid(CL_T, R_T, cfg_t, LOADS, device="cpu")
    assert labels == list(tbuild.SCENARIOS) and lam.shape == (len(labels), 2)


# ---------------------------------------------------------------------------
# the grid and the sweep against the port's looped runs
# ---------------------------------------------------------------------------


def _grid_a_max(cfg, scenario, pad=None):
    scen, cap = tbuild.realize(scenario, CL_T, R_T, cfg.T, pad, device="cpu")
    lam = np.asarray([l * cap for l in LOADS], np.float32)
    return cfg.resolve_a_max(float(lam.max()), float(scen.lam_shape.max()))


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("algo", ALGOS)
def test_grid_cells_equal_looped_runs(algo, mode):
    """simulate_grid on uniform and on rack_outage: every (seed, load) cell
    equals ``simulate(algo, ..., load, seed0 + k, ..., a_max=<the grid's>)``
    in every SimResult field, to the bit; the leaves lead by [2, 2]."""
    cfg = tsim.SimConfig(route_mode=mode, **CFG)
    with one_thread():
        for scenario in (None, "rack_outage"):
            grid = tsim.simulate_grid(algo, CL_T, R_T, LOADS, 2, cfg, seed0=5,
                                      scenario=scenario, device="cpu")
            assert grid.mean_completion_slots.shape == (2, 2)
            assert grid.locality_fractions.shape == (2, 2, 3)
            a_max = _grid_a_max(cfg, scenario)
            for k in range(2):
                for l, load in enumerate(LOADS):
                    one = tsim.simulate(algo, CL_T, R_T, load, 5 + k, cfg,
                                        scenario=scenario, a_max=a_max, device="cpu")
                    _assert_cell(grid, (k, l), one, (scenario, k, load))


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("algo", tsim.ALGORITHMS)
def test_sweep_cells_equal_looped_grids(algo, mode):
    """simulate_sweep over uniform, slow_rack and zipf_hotspot: every [S, K,
    L] cell equals the looped simulate_grid of its scenario with the same
    pad and the sweep's a_max (the [M, 3] path on every scenario)."""
    cfg = tsim.SimConfig(route_mode=mode, **CFG)
    with one_thread():
        a_max = tsim.sweep_grid(CL_T, R_T, cfg, LOADS, NAMES, PAD, device="cpu")[3]
        names, res, tele = tsim.simulate_sweep(algo, CL_T, R_T, LOADS, 2, cfg, seed0=3,
                                               scenarios=NAMES, pad=PAD, device="cpu")
        assert names == NAMES and tele is None
        assert res.mean_completion_slots.shape == (3, 2, 2)
        for s, name in enumerate(NAMES):
            grid = tsim.simulate_grid(algo, CL_T, R_T, LOADS, 2, cfg, seed0=3,
                                      scenario=name, pad=PAD, a_max=a_max, device="cpu")
            _assert_cell(res, (s,), grid, name)


@pytest.mark.parametrize("algo", ["balanced_pandas_pod", "jsq_maxweight_pod", "fcfs"])
def test_sweep_mixes_cells_with_and_without_a_size_law(algo):
    """A sweep over uniform and slow_rack with a lognormal size law: the
    sized cells draw the size law and the others do not, as their looped
    grids do, and every cell equals its looped grid."""
    from repro_torch.scenarios import Scenario, SizeSpec, compose

    sized = compose("slow_rack", Scenario("sized", sizes=SizeSpec(sigma=0.8)))
    names = ["uniform", sized]
    cfg = tsim.SimConfig(route_mode="batched", **CFG)
    with one_thread():
        a_max = tsim.sweep_grid(CL_T, R_T, cfg, LOADS, names, PAD, device="cpu")[3]
        _, res, _ = tsim.simulate_sweep(algo, CL_T, R_T, LOADS, 2, cfg, seed0=2,
                                        scenarios=names, pad=PAD, device="cpu")
        for s, name in enumerate(names):
            grid = tsim.simulate_grid(algo, CL_T, R_T, LOADS, 2, cfg, seed0=2,
                                      scenario=name, pad=PAD, a_max=a_max, device="cpu")
            _assert_cell(res, (s,), grid, s)


def test_sweep_split_over_devices_equals_one_device():
    """The scenario axis split over two devices (here both the CPU, three
    scenarios in chunks of 2 and 1) gives the one-device sweep."""
    cfg = tsim.SimConfig(route_mode="batched", **CFG)
    with one_thread():
        args = ("balanced_pandas_pod", CL_T, R_T, LOADS, 2, cfg)
        kw = dict(seed0=1, scenarios=NAMES, pad=PAD)
        _, one, _ = tsim.simulate_sweep(*args, device="cpu", **kw)
        _, two, _ = tsim.simulate_sweep(*args, devices=["cpu", "cpu"], **kw)
    for name, a, b in zip(one._fields, one, two):
        assert _same(a, b), name


def test_sweep_refuses_telemetry_and_every_entry_point_needs_a_device_choice():
    """A telemetry argument that is not a TelemetryConfig is refused (the
    sweep's telemetry itself: tests/test_torch_telemetry_grid.py)."""
    cfg = tsim.SimConfig(route_mode="batched", **CFG)
    with pytest.raises(TypeError, match="TelemetryConfig"):
        tsim.simulate_sweep("balanced_pandas", CL_T, R_T, LOADS, 1, cfg,
                            scenarios=["uniform"], telemetry=object(), device="cpu")
    if torch.cuda.is_available():
        return          # a card is present: the no-card path is not reachable
    calls = [lambda: tsim.simulate_grid("balanced_pandas", CL_T, R_T, LOADS, 1, cfg),
             lambda: tsim.sweep_grid(CL_T, R_T, cfg, LOADS, ["uniform"]),
             lambda: tsim.simulate_sweep("fcfs", CL_T, R_T, LOADS, 1, cfg,
                                         scenarios=["uniform"]),
             lambda: tbuild.stack_scenarios(["uniform"], CL_T, R_T, 10)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


@pytest.mark.parametrize("ours,theirs", [
    (tsim.simulate_grid, jsim.simulate_grid), (tsim.sweep_grid, jsim.sweep_grid),
    (tsim.simulate_sweep, jsim.simulate_sweep),
    (tbuild.stack_scenarios, jbuild.stack_scenarios)])
def test_grid_entry_points_take_the_reference_arguments(ours, theirs):
    """Positional parameters (names, order and defaults; a default config
    by its fields) are the reference's; the port adds only the keyword-only
    ``device``."""
    default = lambda d: repr(d) if dataclasses.is_dataclass(d) else d
    params = lambda f: [(p.name, default(p.default))
                        for p in inspect.signature(f).parameters.values()
                        if p.kind == p.POSITIONAL_OR_KEYWORD]
    assert params(ours) == params(theirs)
    extra = [p.name for p in inspect.signature(ours).parameters.values()
             if p.kind == p.KEYWORD_ONLY]
    assert extra == ["device"]


# ---------------------------------------------------------------------------
# a slot's cost does not grow with the cells
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod",
                                  "jsq_maxweight_pod", "fcfs"])
def test_a_slot_of_many_cells_issues_the_ops_of_one(algo, monkeypatch):
    """One batched slot step of 6 cells dispatches as many torch ops as
    one of a single cell, and calls route_commit once (none for FCFS), on
    the [M, 3] path of a stacked scenario."""
    cfg = tsim.SimConfig(route_mode="batched", **CFG)
    family = tsim._family(algo)
    counts = []
    for seeds in (1, 3):
        a_max = tsim.sweep_grid(CL_T, R_T, cfg, LOADS, ["uniform"], PAD, device="cpu")[3]
        stacked, _ = tbuild.stack_scenarios(["uniform"], CL_T, R_T, cfg.T, PAD,
                                            device="cpu")
        pod = tsim._pod_for(algo, None)
        sources = [tsim._cell_draws(torch.Generator().manual_seed(k), CL_T, R_T, cfg, pod,
                                    a_max, l * 2.0, tbuild.scenario_row(stacked, 0), family)
                   for k in range(seeds) for l in LOADS]
        grid = tsim.GridDraws(sources)
        draws = grid.view(grid.fill(40), 0)
        N = len(sources)
        kind = {"bp": tsim.BPState, "sq": tsim.SQState, "fcfs": tsim.FCFSState}[family]
        speed = tbuild.speed_at(stacked, 40)[0]
        kw = dict(cluster=CL_T, cfg=cfg, a_max=a_max, measure=True, in_half2=False,
                  speed=speed)
        state, sums = kind.zero(M, "cpu", N), tsim.RawSums.zero("cpu", N)
        consts = tsim.step_consts(CL_T, R_T, pod, a_max, "cpu")
        with _CountOps(monkeypatch) as c:
            if family == "bp":
                tsim._bp_step(state, sums, draws, pod=pod, inv_rate_m=tcl.safe_inv_rates(
                    speed * R_T.as_array()), **kw)
            elif family == "sq":
                tsim._sq_step(state, sums, draws, consts=consts, variant="maxweight",
                              pod=pod, **kw)
            else:
                tsim._fcfs_step(state, sums, draws, consts=consts, **kw)
        counts.append((c.n, c.routes))
        monkeypatch.undo()
    assert counts[0] == counts[1] and counts[0][1] == (family != "fcfs"), counts
