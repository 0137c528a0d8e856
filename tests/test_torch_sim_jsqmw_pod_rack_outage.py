"""Level-3 parity for jsq_maxweight_pod on rack_outage (rack 0 drained for
a tenth of the run): the port's batched ``simulate`` on the CPU against the
JAX ``simulate_grid`` over six seeds (see _torch_sim_helpers.py)."""
import numpy as np

from _torch_sim_helpers import SEEDS, assert_within_ci, jax_batched, port


def test_batched_simulate_agrees_with_jax_within_seed_ci():
    ours = port("jsq_maxweight_pod", "batched", range(SEEDS), scenario="rack_outage")
    assert np.isfinite(ours).all() and (ours[:, 0] > 0).all()
    assert_within_ci(ours, jax_batched("jsq_maxweight_pod", scenario="rack_outage"),
                     "jsq_maxweight_pod on rack_outage: port vs JAX")
