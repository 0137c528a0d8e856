"""A run whose timed path is broken underneath comes out not correct.

Each case drives the rest of a run (set-up, window, comparison) on the CPU
at a tiny size, with the port's grid call broken in one way a cell can be
broken: a slot step that hands back its state unchanged; half of the cells
left out and filled with the mean of the rest; one answer altered where it
is produced; and the control, the plain reference computed in bfloat16 (the
precision below the configuration's float32) in the program's place.  A
single card runs each cell, so no exchange between chips can be left out.
"""
import time

import pytest
import torch

from portbench import harness, reference
from portbench._testing import ALGOS, driver, tiny

SPEC = harness.load_spec()
UNITS = {m["name"]: m["unit"] for m in SPEC["end_to_end"] + SPEC["per_layer"]}
WORKLOAD = SPEC["workloads"][0]["name"]


def _state_unchanged(sim, monkeypatch):
    for name in ("_bp_step", "_sq_step"):
        step = getattr(sim, name)

        def frozen(state, sums, draws, _step=step, **kw):
            return state, _step(state, sums, draws, **kw)[1]
        monkeypatch.setattr(sim, name, frozen)


def _half_batch(sim, monkeypatch):
    grid = sim.simulate_grid

    def half(algo, cluster, rates, loads, n_seeds, *a, **kw):
        res = grid(algo, cluster, rates, loads, n_seeds // 2, *a, **kw)
        fill = lambda x: x if x.ndim < 2 else torch.cat(
            [x, x.mean(dim=0, keepdim=True).expand((n_seeds - x.shape[0],) + x.shape[1:])])
        return type(res)(*map(fill, res))
    monkeypatch.setattr(sim, "simulate_grid", half)


def _answer_altered(sim, monkeypatch):
    summarize = sim.summarize

    def altered(*a, **kw):
        res = summarize(*a, **kw)
        x = res.mean_completion_slots.clone()
        x.view(-1)[0] = torch.nextafter(x.view(-1)[0], torch.tensor(float("inf")))
        return res._replace(mean_completion_slots=x)
    monkeypatch.setattr(sim, "summarize", altered)


def _control(sim, monkeypatch):
    """The reference in bfloat16 put in the program's place."""
    def low(algo, cluster, rates, loads, n_seeds, cfg, pod=None, seed0=0, a_max=None, device=None):
        lams = [float(l) * cluster.M * rates[0] for _ in range(n_seeds) for l in loads]
        g = reference.Grid(algo, cluster.M, cluster.K, tuple(rates),
                           (pod.d_rack, pod.d_remote) if pod else (), cfg.T, cfg.warmup,
                           a_max or reference.a_max_for(lams), cfg.s_max, lams,
                           [seed0 + k for k in range(n_seeds) for _ in loads])
        out = reference.run(g, device, torch.bfloat16)
        shape = lambda v: v.reshape((n_seeds, len(loads)) + v.shape[1:]) if v.ndim else v
        return sim.SimResult(**{k: shape(out[k]) for k in reference.FIELDS})
    monkeypatch.setattr(sim, "simulate_grid", low)


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "answer_altered": _answer_altered, "control_bfloat16": _control}


@pytest.mark.parametrize("fault", list(FAULTS))
@pytest.mark.parametrize("algo", ALGOS)
def test_a_broken_timed_path_is_not_correct(algo, fault, monkeypatch):
    from repro_torch.core import simulator as sim
    torch.set_num_threads(1)
    # the control needs queues long enough for bfloat16 to round them
    config, traffic = tiny(WORKLOAD, T=800 if fault == "control_bfloat16" else 200, algo=algo)
    FAULTS[fault](sim, monkeypatch)
    out = harness.measure(config, traffic, driver(traffic), {}, UNITS, 1234, 0.1, False, "cpu",
                          time.perf_counter())
    assert not out["correct"] and out["failed"] > 0
    assert out["checks"]["result_gap"]["value"] > out["checks"]["result_gap"]["limit"]
