"""The SQ family's and FCFS's slot steps with telemetry against the JAX
reference on ``uniform``: JSQ-MaxWeight, JSQ-MaxWeight-Pod, JSQ-Priority and
FCFS, both route modes (the cases and tolerances:
tests/_torch_telemetry_steps.py)."""
import pytest

from _torch_telemetry_steps import cases, run_case

CASES, IDS = cases(("jsq_maxweight", "jsq_maxweight_pod", "jsq_priority", "fcfs"),
                   "uniform")


@pytest.mark.parametrize("algo,mode", CASES, ids=IDS)
def test_sq_fcfs_telemetry_step_matches_jax_slot_by_slot(algo, mode):
    tele = run_case(algo, mode, "uniform")
    assert float(tele.win[:, 7].sum()) > 0         # arrivals were counted
    assert (float(tele.sojourn_hist.sum()) > 0) == (algo != "fcfs")
