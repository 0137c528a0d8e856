"""The benchmark's harness on the CPU: finding its files by name, the
schema of BENCHMARK.json, the rate over whole calls, the trace's
reduction, the frozen roofline bound, and the plain reference against the
port on a tiny grid."""
import json
import re
import subprocess
import sys
import time

import pytest
import torch

from portbench import bounds, harness, reference
from portbench import trace as tr
from portbench._testing import ALGOS, driver, tiny

SPEC = harness.load_spec()
WORKLOADS = [w["name"] for w in SPEC["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", WORKLOADS)
def test_cell_files_found_by_name(workload):
    entry, config, traffic, driver, readers = harness.find(SPEC, workload)
    assert entry["chips"] == 1 and callable(driver.prepare) and driver.LIMITS
    assert traffic["algo"] in ALGOS and traffic["n_seeds"] >= 1
    assert {"M", "K", "rates", "loads", "T", "warmup", "precision"} <= set(config)
    wanted = {m["name"] for m in SPEC["per_layer"] if workload in m["workloads"]}
    assert set(readers) == wanted and all(callable(r.read) for r in readers.values())


def test_spec_keeps_its_schema():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in SPEC[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        held = json.loads((harness.ROOT / c["file"]).read_text())
        assert set(c["reduced"]) <= set(held) and held["name"] == c["name"]
    assert {(w["config"], w["traffic"]) for w in SPEC["workloads"]}.__len__() == len(WORKLOADS)
    for w in SPEC["workloads"]:
        assert len(w["why"]) <= 200
    for m in SPEC["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in SPEC["end_to_end"])
    ends = {m["name"] for m in SPEC["end_to_end"]}
    for m in SPEC["per_layer"]:
        assert m["moves"] in ends and set(m["workloads"]) <= set(WORKLOADS)
        if "roofline" in m["name"]:
            assert m["unit"] == "%"
    for w in WORKLOADS:
        assert any(w in m["workloads"] for m in SPEC["per_layer"])
    # room for 24 cells, each run 14 times (and 2 runs more), in 12 hours
    runs, secs = 2 + 14 * 24, SPEC["run_seconds"]
    assert runs * (secs + 60) + 24 * 2 * 90 + 1200 <= 43200


class _Calls:
    """A driver stand-in whose calls take a fixed time."""

    def __init__(self, dt):
        self.dt, self.n = dt, 0

    def call(self, i):
        time.sleep(self.dt)
        self.n += 1
        return 10.0


def test_window_counts_whole_calls_only():
    w = harness.window(_Calls(0.05), 0.32)
    calls = w["calls"]
    assert 4 <= len(calls) <= 6
    assert calls[-1][1] - calls[0][0] <= 0.32 + 0.05
    assert all(b - a >= 0.05 for a, b, _ in calls)
    assert len(harness.window(_Calls(0.2), 0.05)["calls"]) == 1


def _synthetic(kernels=None):
    device = kernels or [("k_a", 10.0, 20.0), ("Memcpy HtoD", 20.0, 25.0),
                         ("route_commit_pod_kernel", 40.0, 50.0),
                         ("route_commit_pod_kernel", 70.0, 80.0), ("k_a", 75.0, 90.0)]
    host = [("aten::rand", 0.0, 35.0), ("aten::gather", 55.0, 68.0)]
    return tr.Trace((0.0, 100.0), device, host, 4,
                    {"kernel": "route_commit_pod", "M": 500, "B": 22, "C": 11,
                     "live": [[5, 3], [0, 2]]})


def test_trace_busy_gaps_and_breakdown():
    t = _synthetic()
    assert t.busy() == [[10.0, 25.0], [40.0, 50.0], [70.0, 90.0]]
    assert t.busy_s() == pytest.approx(45e-6)
    assert t.gaps() == [(0.0, 10.0), (25.0, 40.0), (50.0, 70.0), (90.0, 100.0)]
    b = t.breakdown()
    assert b["device_ops"][0] == ["k_a", pytest.approx(25e-6)]
    idle = dict((k, v) for k, v in b["idle_gaps"])
    assert idle["aten::rand"] == pytest.approx(25e-6)
    assert idle["host (no operation)"] == pytest.approx(30e-6)
    load = lambda n: harness.load_module(harness.HERE / "metrics" / f"{n}.py", n)
    assert load("device_idle_share.sim").read(t) == pytest.approx(0.55)
    assert load("slot_launches").read(t) == pytest.approx(4 / 4)
    empty = tr.Trace((0.0, 1.0), [], [], 4, {})
    assert load("device_idle_share.sim").read(empty) is None
    assert load("slot_launches").read(empty) is None


def test_roofline_bound_by_hand():
    # one cell, M=500, B=22, C=11, 22 live arrivals: queues in and out 12 000, workloads
    # 2 000, mask 22, candidates 968 + 242, outputs 264; shared: rates 12, classes 968
    assert bounds.route_commit(500, 22, 11, [[22]]) == pytest.approx(16476 / 3.35e12)
    # only the live arrivals count, and a cell with none needs nothing
    assert bounds.route_commit(500, 22, 11, [[5, 0]]) == pytest.approx(
        (28 * 500 + 22 + 12 * 5 + 5 * 5 * 11 + 4 * 5 * 11 + 12) / 3.35e12)
    assert bounds.route_commit(500, 22, 11, [[0, 0]]) == 0.0
    # full BP at M=5000, two slots of 32 cells with 40 and 93 live arrivals each:
    # the class rows dominate
    slot = lambda b: 32 * (12 * 5000 + 93 + 12 * 5000 + 4 * 5000 + 12 * b + 4 * b * 5000
                           + 4 * 5000) + 12
    least = bounds.route_commit(5000, 93, None, [[40] * 32, [93] * 32])
    assert least == pytest.approx((slot(40) + slot(93)) / 3.35e12)
    assert 32 * (5 * 5000 + 2 * 93 * 5000) / 67e12 < slot(93) / 3.35e12
    t = _synthetic()
    share = harness.load_module(harness.HERE / "metrics" / "route_commit_pod_roofline.sim.py",
                                "r").read(t)
    assert share == pytest.approx(100 * bounds.route_commit(500, 22, 11, [[5, 3], [0, 2]]) / 20e-6)
    full = harness.load_module(harness.HERE / "metrics" / "route_commit_full_roofline.sim.py",
                               "f").read(t)
    assert full is None


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("algo", ALGOS)
def test_reference_equals_the_port_on_a_tiny_grid(algo, heavy):
    from repro_torch.core import simulator as sim
    config, traffic = tiny(WORKLOADS[0], algo=algo)
    if heavy:   # ~30 arrivals a slot on 100 servers at inexact inverse rates: many
        # commits to one server in a slot, whose float32 sum rounds by its order
        config.update(M=100, K=5, T=300, warmup=75, rates=[0.3, 0.15, 0.06], loads=[0.9, 0.99])
    torch.set_num_threads(1)
    run = driver(traffic).prepare(config, traffic, seed=2**31 + 5, device="cpu")
    run.call(0)
    gaps = run.check(__import__("numpy").random.default_rng(0))["result_gap"]
    assert gaps == [0.0] * run.cells
    # and it is the port's own answer, not a constant: cells differ
    r = run.results[0]["mean_completion_slots"].flatten()
    assert len(set(r.tolist())) == run.cells
    assert sim.ALGORITHMS  # the port was imported


@pytest.mark.parametrize("algo", ALGOS[:2])
def test_the_replayed_arrivals_are_the_routed_ones(algo):
    config, traffic = tiny(WORKLOADS[0], algo=algo)
    torch.set_num_threads(1)
    run = driver(traffic).prepare(config, traffic, seed=2**32 + 9, device="cpu")
    run.call(0)
    work = run.route_commit_work(0)
    live = work["live"]
    assert live.shape == (run.T, run.cells) and work["B"] == run.a_max
    assert 0 < live.max() <= run.a_max and (live == 0).any()
    routed = run.results[0]["route_decisions"].reshape(run.cells)
    assert live[run.warmup:].sum(axis=0).tolist() == routed.tolist()


def test_measure_on_the_cpu_end_to_end():
    config, traffic = tiny("grid-m500-bppod")
    _, _, _, driver, readers = harness.find(SPEC, "grid-m500-bppod")
    units = {m["name"]: m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
    out = harness.measure(config, traffic, driver, readers, units, 77, 1.0, False, "cpu",
                          time.perf_counter())
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 4
    assert set(out["metrics"]) == {"cell_slots_per_s", "setup_s"}
    assert out["metrics"]["cell_slots_per_s"]["unit"] == "cell-slots/s"
    assert list(out)[-1] == "checks" and out["checks"]["result_gap"] == {"value": 0.0, "limit": 0.0}
    traced = harness.measure(config, traffic, driver, readers, units, 78, 0.5, True, "cpu",
                             time.perf_counter())
    assert traced["correct"] and "cell_slots_per_s" not in traced["metrics"]
    assert traced["device"]["window_s"] > 0 and "breakdown" in traced


def test_no_jax_in_a_run():
    code = ("import sys; sys.path[:0] = ['.', 'src']\n"
            "from portbench import harness\n"
            "spec = harness.load_spec()\n"
            "for w in spec['workloads']: harness.find(spec, w['name'])\n"
            "from portbench._testing import tiny\n"
            "c, traffic = tiny('grid-m500-bppod')\n"
            "d = harness.find(spec, 'grid-m500-bppod')[3].prepare(c, traffic, 1, 'cpu')\n"
            "d.call(0)\n"
            "print(harness.banned_modules(), 'repro_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]
    assert harness.banned_modules.__doc__ and "repro" in harness.BANNED


def test_banned_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "repro_torch_shadow", object())
    assert "repro" not in harness.banned_modules() or "repro" in {
        n.split(".")[0] for n in sys.modules}
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    assert "jaxlib" in harness.banned_modules()


@pytest.mark.gpu
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "grid-m500-bppod",
                          "--seed", "3", "--seconds", "5", "--trace", "0"],
                         cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"
