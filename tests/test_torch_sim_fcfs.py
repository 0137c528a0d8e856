"""Level-3 parity for fcfs at load 0.15: the port's ``simulate`` on the CPU
against the JAX ``simulate_grid`` over six seeds (see _torch_sim_helpers.py).
FCFS routes nothing, so the route mode does not matter."""
import numpy as np

from _torch_sim_helpers import SEEDS, assert_within_ci, jax_batched, port

LOAD = 0.15


def test_simulate_agrees_with_jax_within_seed_ci():
    ours = port("fcfs", "batched", range(SEEDS), LOAD)
    assert np.isfinite(ours).all() and (ours[:, 0] > 0).all()
    assert_within_ci(ours, jax_batched("fcfs", LOAD), "fcfs: port vs JAX")
