"""The simulator's host spans (``repro_torch.spans``) under a CPU
``torch.profiler``: which names a grid call records, how many of each, how
they nest, and that recording them leaves every result bit for bit as it
is without a profiler."""
import math

import pytest
import torch

from repro_torch.core import simulator as sim
from repro_torch.scenarios import build
from repro_torch.spans import SPANS, span

CL, RATES = sim.Cluster(20, 4), sim.Rates(0.1, 0.05, 0.02)
LOADS, SEEDS = (0.45, 0.85), 2
CELLS = SEEDS * len(LOADS)
# past one draw block of 256 slots, so every cell fills two blocks
CFG = sim.SimConfig(T=260, warmup=65, s_max=16, route_mode="batched")
SHORT = sim.SimConfig(T=40, warmup=10, s_max=16, route_mode="batched")
ALGOS = ("balanced_pandas_pod", "balanced_pandas", "jsq_maxweight_pod", "fcfs")
PHASES = ("sim.step.service", "sim.step.schedule", "sim.step.route",
          "sim.step.accumulate")


@pytest.fixture(autouse=True)
def _one_thread():
    """Tiny tensors: intra-op threads only slow the slot loop down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _traced(run):
    """(run()'s result, [(name, start_ns, end_ns)] of every span recorded
    while it ran, by start)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        out = run()
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(("sim.", "kernels."))]
    return out, sorted(spans, key=lambda s: s[1])


def _count(spans, name) -> int:
    return sum(1 for s in spans if s[0] == name)


def _inside(spans, inner, outer) -> bool:
    """Does every ``inner`` span lie within some ``outer`` span?"""
    outs = [(a, b) for n, a, b in spans if n == outer]
    return all(any(a <= x and y <= b for a, b in outs)
               for n, x, y in spans if n == inner)


def _assert_same(a, b):
    for name, x, y in zip(a._fields, a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0, equal_nan=True,
                                   msg=name)


def _grid(algo, cfg=CFG, **kw):
    return lambda: sim.simulate_grid(algo, CL, RATES, LOADS, SEEDS, cfg,
                                     device="cpu", **kw)


@pytest.mark.parametrize("algo", ALGOS)
def test_a_grid_call_records_each_layer_once_a_unit_of_its_work(algo):
    run = _grid(algo)
    plain = run()
    res, spans = _traced(run)
    _assert_same(res, plain)
    names = {s[0] for s in spans}
    assert names <= set(SPANS)
    for name in ("sim.grid.realize", "sim.grid.cells", "sim.grid.summarize"):
        assert _count(spans, name) == 1, name
    # one draw and one of each phase a slot; no telemetry, no speeds
    assert _count(spans, "sim.draws") == CFG.T
    for name in PHASES:
        assert _count(spans, name) == CFG.T, name
    assert "sim.step.telemetry" not in names and "sim.scenario.speed" not in names
    # every cell fills each of its blocks once, inside a slot's draw
    blocks = math.ceil(CFG.T / 256)
    assert _count(spans, "sim.draws.stack") == blocks
    assert _count(spans, "sim.draws.fill") == CELLS * blocks
    for inner in ("sim.draws.fill", "sim.draws.stack", "sim.draws.class_grid"):
        assert _inside(spans, inner, "sim.draws"), inner
    # batched routing: one kernel wrapper a slot, inside the route phase
    # (FCFS routes nothing: its arrivals join the central queue)
    wrappers = _count(spans, "kernels.route_commit")
    assert wrappers == (0 if algo == "fcfs" else CFG.T)
    assert _inside(spans, "kernels.route_commit", "sim.step.route")
    assert ("sim.draws.class_grid" in names) == (algo == "balanced_pandas")


def test_the_slot_loop_lies_between_the_grid_spans():
    """The fixed cost a call and the slot loop do not overlap, and no two
    phases of a slot do."""
    _, spans = _traced(_grid("balanced_pandas_pod", SHORT))
    end = lambda n: next(b for m, _, b in spans if m == n)
    start = lambda n: next(a for m, a, _ in spans if m == n)
    first = min(a for n, a, _ in spans if n == "sim.draws")
    last = max(b for n, _, b in spans if n.startswith("sim.step."))
    assert end("sim.grid.realize") <= start("sim.grid.cells")
    assert end("sim.grid.cells") <= first and last <= start("sim.grid.summarize")
    top = [s for s in spans if s[0] == "sim.draws" or s[0] in PHASES]
    assert all(b <= c for (_, _, b), (_, c, _) in zip(top, top[1:]))


def test_sequential_routing_records_the_route_phase_without_the_kernel():
    cfg = sim.SimConfig(T=40, warmup=10, s_max=16, route_mode="sequential")
    run = _grid("balanced_pandas", cfg)
    plain = run()
    res, spans = _traced(run)
    _assert_same(res, plain)
    assert _count(spans, "sim.step.route") == cfg.T
    assert _count(spans, "kernels.route_commit") == 0


@pytest.mark.parametrize("algo", ("balanced_pandas_pod", "jsq_maxweight_pod"))
def test_a_scenario_reads_its_speeds_once_a_slot(algo):
    run = _grid(algo, SHORT, scenario="slow_rack", pad=build.canonical_pad(CL))
    plain = run()
    res, spans = _traced(run)
    _assert_same(res, plain)
    assert _count(spans, "sim.scenario.speed") == SHORT.T
    assert {s[0] for s in spans} <= set(SPANS)


@pytest.mark.parametrize("algo,sites", (("balanced_pandas_pod", 3),
                                        ("jsq_maxweight_pod", 3), ("fcfs", 1)))
def test_telemetry_records_its_collectors_and_changes_nothing(algo, sites):
    """The collectors are the telemetry phase: the rings' pops and pushes
    and the windows' step, each a span of its own."""
    run = lambda: sim.simulate_grid_with_telemetry(
        algo, CL, RATES, LOADS, SEEDS, SHORT, device="cpu")
    plain, tele = run()
    (res, tele2), spans = _traced(run)
    _assert_same(res, plain)
    _assert_same(tele2, tele)
    assert _count(spans, "sim.step.telemetry") == sites * SHORT.T
    for name in PHASES:
        assert _count(spans, name) == SHORT.T, name


def test_simulate_and_the_sweep_record_the_grid_spans():
    cfg = sim.SimConfig(T=20, warmup=5, s_max=16, route_mode="batched")
    _, spans = _traced(lambda: sim.simulate(
        "balanced_pandas_pod", CL, RATES, 0.5, 3, cfg, device="cpu"))
    for name in ("sim.grid.realize", "sim.grid.cells", "sim.grid.summarize"):
        assert _count(spans, name) == 1, name
    _, spans = _traced(lambda: sim.simulate_sweep(
        "balanced_pandas_pod", CL, RATES, LOADS, SEEDS, cfg,
        scenarios=["uniform", "slow_rack"], pad=build.canonical_pad(CL),
        devices=["cpu", "cpu"]))
    assert _count(spans, "sim.grid.realize") == 1
    assert _count(spans, "sim.grid.cells") == 2      # one a chunk of scenarios
    assert _count(spans, "sim.grid.summarize") == 1
    assert _count(spans, "sim.scenario.speed") == 2 * cfg.T
    assert {s[0] for s in spans} <= set(SPANS)


def test_a_span_without_a_profiler_is_one_shared_null_context():
    assert span("sim.draws") is span("sim.step.route")
    with span("sim.draws") as inside:
        assert inside is None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert span("sim.draws") is not span("sim.draws")
    assert len(SPANS) == len(set(SPANS))
