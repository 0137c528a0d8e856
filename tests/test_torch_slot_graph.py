"""The BP family's slot step replayed as CUDA graphs (``simulator._SlotGraphs``).

On the CPU: the weighted accumulators against their branch form, the
capture rule condition by condition, the stack into held buffers, the
draw sources' slot views (full BP's class grid derived in one place), and
the one slot loop stepped eagerly over more than one draw block, on the
homogeneous path and off it, against the looped runs; a caller's draw
source as blocks of one slot.  On the card (marked ``gpu``, skipping
without a CUDA device): captured grids and scenario sweeps against the
eager loop bit for bit, the graphs reused by a second call, the launch
counters, no host sync in the replayed loop, and the spans of the paths
that stay eager.  This file imports no JAX.
"""
import collections
import contextlib

import pytest
import torch

from repro_torch.core import simulator as sim
from repro_torch.core.cluster import locality_class
from repro_torch.kernels import LAUNCHES, MATRIX_LAUNCHES, reset_launch_counts
from repro_torch.scenarios import build, realize

PAPER = sim.Rates(0.01, 0.005, 0.002)
CL = sim.Cluster(500, 10)
LOADS, SEEDS = (0.5, 0.9), 2
# warmup (150) and the half-way point (376) fall inside blocks of 256; the
# last block is partial: 91 slots, 11 chunks of 8 and 3 slots stepped eagerly
CFG = sim.SimConfig(T=603, warmup=150, route_mode="batched")
BP_ALGOS = ("balanced_pandas_pod", "balanced_pandas", "balanced_pandas_randomtie")


def _branch_acc(sums, *, in_half2, N, arr, clipped, comp, starts, routed,
                busy_n, routes, scheds, measure):
    """The accumulators as they were written with Python branches."""
    if not measure:
        return sums._replace(final_N=N)
    zero = torch.zeros_like(N)
    inc = torch.cat([torch.stack([
        torch.ones_like(N), N, zero if in_half2 else N, N if in_half2 else zero,
        arr, clipped, comp], dim=-1), starts, routed,
        torch.stack([busy_n, routes, scheds], dim=-1)], dim=-1)
    cur = torch.cat([torch.stack(sums[:7], dim=-1), sums.starts, sums.routed,
                     torch.stack(sums[9:12], dim=-1)], dim=-1)
    new = cur + inc
    return sim.RawSums(*new[..., :7].unbind(-1), new[..., 7:10], new[..., 10:13],
                       *new[..., 13:16].unbind(-1), final_N=N)


def _same_bits(a, b):
    for name, x, y in zip(a._fields, a, b):
        assert x.shape == y.shape and torch.equal(x.view(torch.int32),
                                                  y.view(torch.int32)), name


def _bitwise(a, b):
    for name, x, y in zip(a._fields, a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True, msg=name)


@pytest.mark.parametrize("weights", ["bool", "tensor"])
@pytest.mark.parametrize("measure,in_half2",
                         [(False, False), (False, True), (True, False), (True, True)])
def test_weighted_acc_equals_the_branch_form(measure, in_half2, weights):
    g = torch.Generator().manual_seed(2 * measure + in_half2)
    cells = 7
    f = lambda *s: torch.rand((cells,) + s, generator=g)
    # sums of every size a long run reaches, with fractional parts that a
    # rounding of the weighted add would show
    sums = sim.RawSums(*(x * 10.0 ** torch.randint(0, 8, x.shape, generator=g)
                         for x in (f(), f(), f(), f(), f(), f(), f(), f(3), f(3),
                                   f(), f(), f(), f())))
    count = lambda *s: torch.randint(0, 500, (cells,) + s, generator=g).float()
    kw = dict(N=count() + 0.5, arr=count(), clipped=count(), comp=count(),
              starts=count(3), routed=count(3), busy_n=count(), routes=count(),
              scheds=count())
    w = (lambda x: x) if weights == "bool" else \
        (lambda x: torch.tensor(float(x)))
    got = sim._acc(sums, measure=w(measure), in_half2=w(in_half2), **kw)
    _same_bits(got, _branch_acc(sums, measure=measure, in_half2=in_half2, **kw))


RULE = dict(device=torch.device("cuda"), algo="balanced_pandas_pod",
            route_mode="batched", sized=False, telemetry=False,
            grid_draws=True, T=5000, block=256)


@pytest.mark.parametrize("change,captured", [
    ({}, True),
    ({"algo": "balanced_pandas"}, True),
    ({"algo": "balanced_pandas_randomtie"}, True),
    ({"T": 256}, True),
    ({"device": torch.device("cuda:1")}, True),
    ({"device": torch.device("cpu")}, False),
    ({"algo": "jsq_maxweight_pod"}, False),
    ({"algo": "jsq_priority"}, False),
    ({"algo": "fcfs"}, False),
    ({"algo": "jsq_maxweight"}, False),
    ({"route_mode": "sequential"}, False),
    ({"sized": True}, False),
    ({"telemetry": True}, False),
    ({"grid_draws": False}, False),
    ({"T": 255}, False),
    # BP-Pod's draw block at M=5000: a call of one block, and one short of it
    ({"T": 9, "block": 9}, True),
    ({"T": 8, "block": 9}, False),
])
def test_capture_rule(change, captured):
    assert sim._captures(**{**RULE, **change}) is captured


@pytest.mark.parametrize("cells", [1, 3])
@pytest.mark.parametrize("n", [5, 8])
def test_stack_into_held_buffers(cells, n):
    g = torch.Generator().manual_seed(cells * 10 + n)
    parts = [sim.SlotDraws(torch.randint(0, 9, (n,), generator=g).int(),
                           torch.randint(0, 40, (n, 4, 3), generator=g).int(), None,
                           torch.randint(1, 99, (n, 40, 3), generator=g).int(),
                           cand_valid=torch.rand((n, 4, 5), generator=g) < 0.5)
             for _ in range(cells)]
    want = sim._stack_cells(parts)
    held = sim.SlotDraws(*(None if x is None else torch.full(
        (8, cells) + x.shape[1:], 1, dtype=x.dtype) for x in parts[0]))
    got = sim._stack_cells(parts, held)
    for name, x, y, h in zip(want._fields, want, got, held):
        if x is None:
            assert y is None and h is None, name
            continue
        assert torch.equal(x, y) and torch.equal(h[:n], x), name
        assert y.data_ptr() == h.data_ptr(), name
        assert (h[n:] == 1).all(), name        # rows past the block's slots kept


SMALL, SMALL_RATES = sim.Cluster(20, 4), sim.Rates(0.1, 0.05, 0.02)
# two draw blocks of 256 slots, the last partial (84 slots); straggler_wave's
# last window (slots 221-289) spans the blocks' boundary
SMALL_CFG = sim.SimConfig(T=340, warmup=85, s_max=16, route_mode="batched")
SMALL_LOADS = (0.45, 0.85)


@contextlib.contextmanager
def one_thread():
    """Tiny tensors: intra-op threads only slow the slot loop down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(n)


def _cell_equals(result, index, one, label):
    for name, x, y in zip(one._fields, result, one):
        x = x[index] if x.ndim > y.ndim else x      # per-call scalars stay
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                   msg=f"{label} {name}")


@pytest.mark.parametrize("algo", BP_ALGOS)
@pytest.mark.parametrize("case", ["uniform", "straggler_wave", "sweep"])
def test_the_one_loop_over_draw_blocks_equals_the_looped_runs_on_the_cpu(algo, case):
    """The slot loop on the CPU, every slot stepped eagerly from the block's
    slot views: over two draw blocks, the last partial, every grid or sweep
    cell equals its looped ``simulate`` run bit for bit, on the homogeneous
    path, on one scenario's [M, 3] speeds and on a two-scenario sweep's
    stacked speeds (computed from the loop's operands); no graph is held."""
    pad = build.canonical_pad(SMALL)
    with one_thread():
        if case == "sweep":
            names = ["slow_rack", "rack_outage"]
            a_max = sim.sweep_grid(SMALL, SMALL_RATES, SMALL_CFG, SMALL_LOADS, names, pad,
                                   device="cpu")[3]
            res = sim.simulate_sweep(algo, SMALL, SMALL_RATES, SMALL_LOADS, 2, SMALL_CFG,
                                     seed0=3, scenarios=names, pad=pad, device="cpu")[1]
        else:
            names, pad = [case], None
            scen, cap = realize(case, SMALL, SMALL_RATES, SMALL_CFG.T, device="cpu")
            lam = torch.tensor([l * cap for l in SMALL_LOADS])      # float32, as the grid's
            a_max = SMALL_CFG.resolve_a_max(float(lam.max()), float(scen.lam_shape.max()))
            res = sim.simulate_grid(algo, SMALL, SMALL_RATES, SMALL_LOADS, 2, SMALL_CFG,
                                    seed0=3, scenario=case, device="cpu")
        for s, name in enumerate(names):
            for k in range(2):
                for l, load in enumerate(SMALL_LOADS):
                    one = sim.simulate(algo, SMALL, SMALL_RATES, load, 3 + k, SMALL_CFG,
                                       scenario=name, pad=pad, a_max=a_max, device="cpu")
                    cell = (s, k, l) if case == "sweep" else (k, l)
                    _cell_equals(res, cell, one, (name, k, load))
    assert not sim._GRAPHS


def _source(algo, cfg, a_max=9, seed=4, lam=2.0):
    lam_t = torch.full((cfg.T,), lam)
    return sim.TorchDraws(torch.Generator().manual_seed(seed), SMALL, SMALL_RATES, cfg,
                          sim._pod_for(algo, None), a_max, lam_t, sim._family(algo))


@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod",
                                  "jsq_maxweight_pod", "fcfs"])
def test_a_grid_slot_view_is_the_cell_draws_with_full_bp_class_grid(algo):
    """``GridDraws.view`` of a filled one-cell block is ``TorchDraws(t)`` of
    that cell, lifted, at a block's first and last slot and past a block's
    end; full BP's class grid is ``locality_class`` of the slot's replica
    triples, and no other family's draws carry one."""
    cfg = sim.SimConfig(T=300, warmup=0, s_max=16, route_mode="batched")
    grid, one = sim.GridDraws([_source(algo, cfg)]), _source(algo, cfg)
    assert grid.block == 256
    for t0 in range(0, cfg.T, grid.block):
        buf = grid.fill(t0)
        assert buf.raw.shape == (min(grid.block, cfg.T - t0), 1)
        for i in (0, buf.raw.shape[0] - 1):
            got, want = grid.view(buf, i), one(t0 + i)
            for name, x, y in zip(want._fields, got, want):
                assert (x is None) == (y is None), name
                assert x is None or torch.equal(x[0], y), (t0 + i, name)
            full_bp = algo == "balanced_pandas"
            assert (getattr(want, "cls", None) is not None) == full_bp
            if full_bp:
                assert torch.equal(want.cls, locality_class(SMALL, want.locals_))


@pytest.mark.parametrize("algo", ["balanced_pandas", "balanced_pandas_pod",
                                  "jsq_maxweight_pod", "fcfs"])
def test_a_callers_draw_source_runs_the_loop_in_blocks_of_one_slot(algo):
    """``simulate(draws=...)`` with the default source's own ``TorchDraws``
    (one slot a call, full BP's class grid derived by it): the loop takes
    it as blocks of one slot of one cell, and the result is the default
    run's bit for bit."""
    cfg = sim.SimConfig(T=300, warmup=75, s_max=16, route_mode="batched")
    load = 0.7
    lam = load * realize(None, SMALL, SMALL_RATES, cfg.T, device="cpu")[1]
    a_max = cfg.resolve_a_max(lam)
    with one_thread():
        want = sim.simulate(algo, SMALL, SMALL_RATES, load, 4, cfg, a_max=a_max, device="cpu")
        got = sim.simulate(algo, SMALL, SMALL_RATES, load, 4, cfg, a_max=a_max, device="cpu",
                           draws=_source(algo, cfg, a_max, lam=lam))
    _bitwise(got, want)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card: pytest -m gpu)")
    return torch.device("cuda")


@pytest.fixture
def fresh(monkeypatch, dev):
    """An empty graph cache, and a count of the captures made."""
    monkeypatch.setattr(sim, "_GRAPHS", collections.OrderedDict())
    captures = []
    capture = sim._SlotGraphs.capture

    def counted(self, step):
        captures.append(self)
        return capture(self, step)
    monkeypatch.setattr(sim._SlotGraphs, "capture", counted)
    return captures


@contextlib.contextmanager
def _eager(monkeypatch):
    """The eager loop, whatever the capture rule says."""
    with monkeypatch.context() as m:
        m.setattr(sim, "_captures", lambda *a, **k: False)
        yield


def _strict(loop):
    """``loop`` (the slot loop) with any host sync with the card an error."""
    def strict(*a, **k):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return loop(*a, **k)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return strict


def _grid(dev, algo, seed0=0, cfg=CFG):
    return sim.simulate_grid(algo, CL, PAPER, LOADS, SEEDS, cfg, seed0=seed0, device=dev)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", BP_ALGOS)
def test_captured_grid_equals_the_eager_loop(dev, fresh, monkeypatch, algo):
    with _eager(monkeypatch):
        want = _grid(dev, algo)
    got = _grid(dev, algo)
    assert len(fresh) == 1
    _bitwise(got, want)
    # a second call at new seeds replays the same graphs
    with _eager(monkeypatch):
        want = _grid(dev, algo, seed0=11)
    got = _grid(dev, algo, seed0=11)
    assert len(fresh) == 1 and len(sim._GRAPHS) == 1
    _bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["balanced_pandas_pod", "balanced_pandas"])
def test_captured_simulate_equals_the_eager_loop(dev, fresh, monkeypatch, algo):
    run = lambda: sim.simulate(algo, CL, PAPER, 0.9, 5, CFG, device=dev)
    with _eager(monkeypatch):
        want = run()
    _bitwise(run(), want)
    _bitwise(run(), want)
    assert len(fresh) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["balanced_pandas_pod", "balanced_pandas"])
def test_route_commit_launches_once_a_slot(dev, fresh, algo):
    name = "route_commit_pod" if algo.endswith("pod") else "route_commit_full"
    for seed0 in (0, 4):            # the call that captures, then one that replays
        torch.cuda.synchronize()
        reset_launch_counts()
        _grid(dev, algo, seed0=seed0)
        assert LAUNCHES[name] == CFG.T and sum(LAUNCHES.values()) == CFG.T
    assert len(fresh) == 1


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["balanced_pandas_pod", "balanced_pandas"])
def test_a_replayed_loop_never_syncs_with_the_host(dev, fresh, monkeypatch, algo):
    _grid(dev, algo)                # captures
    with _eager(monkeypatch):
        want = _grid(dev, algo, seed0=7)
    monkeypatch.setattr(sim, "_slot_loop", _strict(sim._slot_loop))
    _bitwise(_grid(dev, algo, seed0=7), want)
    assert len(fresh) == 1


def _span_counts(run) -> collections.Counter:
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    return collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                               if e.name().startswith("sim."))


@pytest.mark.gpu
def test_a_replayed_slot_records_no_step_span(dev, fresh):
    cfg = sim.SimConfig(T=520, warmup=130, route_mode="batched")   # 2 blocks and 8 slots
    _grid(dev, "balanced_pandas_pod", cfg=cfg)
    n = _span_counts(lambda: _grid(dev, "balanced_pandas_pod", 3, cfg))
    assert not [k for k in n if k.startswith("sim.step.")]
    assert n["sim.draws"] == 3 and n["sim.draws.stack"] == 3


@pytest.mark.gpu
@pytest.mark.parametrize("case", ["sq", "telemetry", "sequential", "short"])
def test_the_eager_paths_record_their_step_spans(dev, fresh, case):
    cfg = CFG if case != "short" else sim.SimConfig(T=40, warmup=10, route_mode="batched")
    if case == "sequential":
        cfg = sim.SimConfig(T=300, warmup=75, route_mode="sequential")
    if case == "telemetry":
        run = lambda: sim.simulate_with_telemetry("balanced_pandas_pod", CL, PAPER, 0.9, 1,
                                                  cfg, device=dev)
    else:
        algo = "jsq_maxweight_pod" if case == "sq" else "balanced_pandas_pod"
        run = lambda: _grid(dev, algo, cfg=cfg)
    n = _span_counts(run)
    for name in ("sim.draws", "sim.step.service", "sim.step.schedule", "sim.step.route",
                 "sim.step.accumulate"):
        assert n[name] == cfg.T, name
    assert not fresh


# ---------------------------------------------------------------------------
# Off the homogeneous path, on the card
# ---------------------------------------------------------------------------

# rack_outage's window (slots 271-331) opens and closes inside the second
# block; CFG's last block is partial
SCENS = ["slow_rack", "rack_outage", "straggler_wave"]


def _holds_speed_operands(entry) -> bool:
    """Off the homogeneous path the graphs hold the scenario's speed
    operands and compute each slot's inverse rates from them."""
    return set(sim._SPEED_OPERANDS) < set(entry.fixed) and "inv_rate_m" not in entry.fixed


def _sweep(dev, algo, seed0=0, cfg=CFG, a_max=None):
    return sim.simulate_sweep(algo, CL, PAPER, LOADS, SEEDS, cfg, seed0=seed0,
                              scenarios=SCENS, a_max=a_max, device=dev)[1]


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["balanced_pandas_pod", "balanced_pandas"])
def test_captured_sweep_equals_the_eager_loop(dev, fresh, monkeypatch, algo):
    with _eager(monkeypatch):
        want = _sweep(dev, algo)
    got = _sweep(dev, algo)
    assert len(fresh) == 1 and _holds_speed_operands(fresh[0])
    assert fresh[0].block < CFG.T < 3 * fresh[0].block
    _bitwise(got, want)
    # a second call at new seeds realizes and stacks the scenarios anew and
    # replays the same graphs
    with _eager(monkeypatch):
        want = _sweep(dev, algo, seed0=11)
    got = _sweep(dev, algo, seed0=11)
    assert len(fresh) == 1 and len(sim._GRAPHS) == 1
    _bitwise(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("algo", ["balanced_pandas_pod", "balanced_pandas"])
def test_captured_scenario_grid_equals_the_eager_loop(dev, fresh, monkeypatch, algo):
    """One scenario shared by every cell: [M, 3] speeds, not a stack."""
    run = lambda seed0: sim.simulate_grid(algo, CL, PAPER, LOADS, SEEDS, CFG, seed0=seed0,
                                          scenario="straggler_wave", device=dev)
    for seed0 in (0, 5):
        with _eager(monkeypatch):
            want = run(seed0)
        _bitwise(run(seed0), want)
    assert len(fresh) == 1 and _holds_speed_operands(fresh[0])


@pytest.mark.gpu
def test_a_captured_sweep_launches_route_commit_once_a_slot(dev, fresh):
    for seed0 in (0, 4):            # the call that captures, then one that replays
        torch.cuda.synchronize()
        reset_launch_counts()
        _sweep(dev, "balanced_pandas_pod", seed0=seed0)
        assert LAUNCHES["route_commit_pod"] == CFG.T and sum(LAUNCHES.values()) == CFG.T
        assert MATRIX_LAUNCHES["route_commit_pod"] == CFG.T
    assert len(fresh) == 1


@pytest.mark.gpu
def test_a_replayed_sweep_never_syncs_with_the_host(dev, fresh, monkeypatch):
    _sweep(dev, "balanced_pandas_pod")          # captures
    with _eager(monkeypatch):
        want = _sweep(dev, "balanced_pandas_pod", seed0=7)
    monkeypatch.setattr(sim, "_slot_loop", _strict(sim._slot_loop))
    _bitwise(_sweep(dev, "balanced_pandas_pod", seed0=7), want)
    assert len(fresh) == 1


@pytest.mark.gpu
def test_a_replayed_scenario_slot_records_no_speed_span(dev, fresh):
    a_max = sim.sweep_grid(CL, PAPER, CFG, LOADS, SCENS, device=dev)[3]
    _sweep(dev, "balanced_pandas_pod", a_max=a_max)                 # captures
    B = fresh[0].block
    # two blocks, one chunk of 8 replayed and 3 slots stepped eagerly
    cfg = sim.SimConfig(T=2 * B + 11, warmup=130, route_mode="batched")
    n = _span_counts(lambda: _sweep(dev, "balanced_pandas_pod", 3, cfg, a_max))
    assert n["sim.scenario.speed"] == 3 and n["sim.step.service"] == 3
    assert n["sim.step.route"] == 3 and n["sim.draws"] == 3
    assert len(fresh) == 1
