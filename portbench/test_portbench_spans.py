"""The readers of the program's host spans (``portbench/metrics/_spans.py``
and the four metrics on it) on a trace built by hand, where each value is
known exactly; the names they read against the program's own."""
import pytest
import torch

from portbench import harness
from portbench import trace as tr
from portbench.metrics import _spans

READERS = ("draws_idle_share.sim", "step_idle_share.sim", "route_idle_share.sim",
           "grid_fixed_ms.sim")


def _reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", name)


def _trace(host=None, device=None):
    """A 1 000 us window.  The device runs [100, 200], [300, 350] and [600,
    700], so it idles in (0, 100), (200, 300), (350, 600) and (700, 1 000):
    750 us.  The host: the grid's set-up, one slot (its draws with a fill
    inside, four phases, the kernel's wrapper inside the route) and the
    summary, which runs past the window's end."""
    device = device if device is not None else [
        ("k_a", 100.0, 200.0), ("k_b", 300.0, 350.0), ("Memcpy HtoD", 600.0, 700.0)]
    host = host if host is not None else [
        ("sim.grid.realize", 0.0, 50.0), ("sim.grid.cells", 50.0, 120.0),
        ("sim.draws", 120.0, 260.0), ("sim.draws.fill", 130.0, 250.0),
        ("aten::rand", 135.0, 190.0), ("sim.step.service", 260.0, 280.0),
        ("sim.step.schedule", 280.0, 400.0), ("aten::sum", 290.0, 310.0),
        ("sim.step.route", 400.0, 640.0), ("kernels.route_commit", 420.0, 630.0),
        ("sim.step.accumulate", 640.0, 800.0), ("sim.grid.summarize", 900.0, 1010.0)]
    return tr.Trace((0.0, 1000.0), sorted(device, key=lambda e: e[1]),
                    sorted(host, key=lambda e: e[1]), 1, {})


def test_each_reader_on_known_spans_and_gaps():
    t = _trace()
    assert t.gaps() == [(0.0, 100.0), (200.0, 300.0), (350.0, 600.0), (700.0, 1000.0)]
    # draws [120, 260] idles in (200, 260)
    assert _reader("draws_idle_share.sim").read(t) == pytest.approx(60 / 1000)
    # service + schedule [260, 400] and accumulate [640, 800]: (260, 300), (350, 400),
    # (700, 800)
    assert _reader("step_idle_share.sim").read(t) == pytest.approx(190 / 1000)
    # route [400, 640]: (400, 600); the device is busy from 600
    assert _reader("route_idle_share.sim").read(t) == pytest.approx(200 / 1000)
    # 50 + 70 + the summary's 100 us inside the window
    assert _reader("grid_fixed_ms.sim").read(t) == pytest.approx(0.22)
    # the grid's own idle time, and what no span covers: (800, 900)
    assert _spans.idle_s(t, _spans.GRID) == pytest.approx(200e-6)
    covered = sum(_spans.idle_s(t, g) for g in (_spans.DRAWS, _spans.STEP, _spans.ROUTE,
                                                _spans.GRID))
    assert 1 - t.busy_s() / t.window_s - covered / t.window_s == pytest.approx(0.1)


def test_nested_and_overlapping_spans_count_once():
    host = [("sim.step.service", 0.0, 150.0), ("sim.step.schedule", 100.0, 320.0),
            ("sim.step.telemetry", 120.0, 130.0), ("sim.scenario.speed", 900.0, 950.0)]
    t = _trace(host=host)
    # union [0, 320] and [900, 950] against the gaps: 100 + 100 + 50
    assert _reader("step_idle_share.sim").read(t) == pytest.approx(250 / 1000)
    assert _spans.union([(0, 5), (1, 2), (5, 7), (8, 9)]) == [[0, 7], [8, 9]]
    assert _spans.overlap_us([[0, 10], [20, 30]], [[5, 25]]) == 10


@pytest.mark.parametrize("name", READERS)
def test_a_reader_reads_nothing_without_its_spans(name):
    no_spans = _trace(host=[("aten::add", 0.0, 900.0), ("portbench.other", 0.0, 10.0)])
    assert _reader(name).read(no_spans) is None
    assert _reader(name).read(_trace(device=[])) is None      # no device operation
    assert _reader(name).read(tr.Trace((0.0, 1.0), [], [], 1, {})) is None


def test_the_names_read_are_the_programs():
    """A span renamed in the program fails here, not silently in a run."""
    from repro_torch.spans import SPANS
    assert set(_spans.NAMES) <= set(SPANS)
    # every span the readers leave out lies inside one they read
    assert set(SPANS) - set(_spans.NAMES) == {
        "sim.draws.fill", "sim.draws.stack", "sim.draws.class_grid", "kernels.route_commit"}
    layers = (_spans.DRAWS, _spans.STEP, _spans.ROUTE, _spans.GRID)
    assert sum(map(len, layers)) == len(set(_spans.NAMES))


def _profiled_call(device):
    """A trace of one tiny grid call on ``device`` inside the benchmark's
    span, as the harness takes it."""
    from portbench._testing import driver, tiny
    config, traffic = tiny("grid-m500-bppod", T=40)
    run = driver(traffic).prepare(config, traffic, seed=2**31 + 1, device=device)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(tr.SPAN):
            run.call(0)
    return tr.from_profile(prof, run.slot_steps(1), run.route_commit_work(0)), run


def test_the_programs_spans_reach_the_host_list_of_a_trace():
    torch.set_num_threads(1)
    t, run = _profiled_call("cpu")
    names = [n for n, _, _ in t.host]
    for n in _spans.GRID:
        assert names.count(n) == 1, n
    assert names.count("sim.draws") == run.T == names.count("sim.step.route")
    assert names.count("kernels.route_commit") == run.T


@pytest.mark.gpu
def test_no_span_reaches_the_device_timeline():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    t, run = _profiled_call("cuda:0")
    assert not [n for n, _, _ in t.device if n.startswith(("sim.", "kernels."))]
    names = {n for n, _, _ in t.host}
    assert set(_spans.NAMES) - {"sim.step.telemetry", "sim.scenario.speed"} <= names
    for name in READERS:
        assert _reader(name).read(t) is not None, name
