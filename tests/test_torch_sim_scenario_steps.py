"""Step parity of the BP family on heterogeneous scenarios: Balanced-Pandas
in both route modes and Balanced-Pandas-Pod, on slow_rack, rack_outage
(across its window), zipf_hotspot and slow_rack with a lognormal size law,
240 slots side by side with the JAX step, equal after every slot (see
_torch_scenario_steps.py)."""
import pytest

from _torch_scenario_steps import cases, run_case

CASES, IDS = cases((("balanced_pandas", "batched"),
                    ("balanced_pandas", "sequential"),
                    ("balanced_pandas_pod", "batched")))


@pytest.mark.parametrize("algo,mode,scenario", CASES, ids=IDS)
def test_step_matches_jax_slot_by_slot(algo, mode, scenario):
    run_case(algo, mode, scenario)
