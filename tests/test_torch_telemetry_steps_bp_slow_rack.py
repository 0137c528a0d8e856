"""The BP family's slot steps with telemetry against the JAX reference on
``slow_rack``: Balanced-Pandas, BP-Pod and BP with random ties, both route
modes (the cases and tolerances: tests/_torch_telemetry_steps.py)."""
import pytest

from _torch_telemetry_steps import cases, run_case

CASES, IDS = cases(("balanced_pandas", "balanced_pandas_pod",
                    "balanced_pandas_randomtie"), "slow_rack")


@pytest.mark.parametrize("algo,mode", CASES, ids=IDS)
def test_bp_telemetry_step_matches_jax_slot_by_slot(algo, mode):
    tele = run_case(algo, mode, "slow_rack")
    assert float(tele.win[:, 13].sum()) > 0        # probe decisions were made
    assert float(tele.sojourn_hist.sum()) > 0
