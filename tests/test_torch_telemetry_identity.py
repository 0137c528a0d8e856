"""Collectors take no draw: on the CPU, a run with telemetry is
bit-identical to the run without it, for every algorithm (and
Balanced-Pandas with random ties) in both route modes, also with a ring of
one record that overflows at any queue (records drop, tasks do not).
Over a grid: tests/test_torch_telemetry_grid.py."""
import pytest
import torch

from _torch_sim_helpers import one_thread
from repro_torch.core import simulator as tsim
from repro_torch.core.cluster import Cluster, Rates
from repro_torch.telemetry import collectors as ttlm

CL, R = Cluster(M=20, K=4), Rates(0.1, 0.05, 0.02)
ALGOS = tsim.ALGORITHMS + ("balanced_pandas_randomtie",)


def _same(a, b) -> bool:
    return torch.equal(a, b) or bool(a.isnan().all() and b.isnan().all())


@pytest.mark.parametrize("mode", ["batched", "sequential"])
@pytest.mark.parametrize("algo", ALGOS)
def test_telemetry_on_is_bit_identical_to_off(algo, mode):
    cfg = tsim.SimConfig(T=500, warmup=120, route_mode=mode)
    with one_thread():
        off = tsim.simulate(algo, CL, R, 0.85, 5, cfg, device="cpu")
        on, tele = tsim.simulate_with_telemetry(algo, CL, R, 0.85, 5, cfg, device="cpu")
        tiny, tele2 = tsim.simulate_with_telemetry(
            algo, CL, R, 0.85, 5, cfg, telemetry=ttlm.TelemetryConfig(ring_cap=1),
            device="cpu")
    for name, a, b, c in zip(off._fields, off, on, tiny):
        assert _same(a, b) and _same(a, c), name
    win = tele.win.sum(dim=0)
    assert float(win[0]) == cfg.T                   # every slot in one window
    assert float(win[7]) > 0
    if algo != "fcfs":                              # a ring of one drops records
        assert float(tele2.sojourn_dropped) > 0 and float(tele.sojourn_dropped) == 0


