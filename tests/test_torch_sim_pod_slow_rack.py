"""Level-3 parity for balanced_pandas_pod on slow_rack (rack 0 at half
speed, the [M, 3] rate operand on route_commit every slot): the port's
batched ``simulate`` on the CPU against the JAX ``simulate_grid`` over six
seeds (see _torch_sim_helpers.py)."""
import numpy as np

from _torch_sim_helpers import SEEDS, assert_within_ci, jax_batched, port


def test_batched_simulate_agrees_with_jax_within_seed_ci():
    ours = port("balanced_pandas_pod", "batched", range(SEEDS), scenario="slow_rack")
    assert np.isfinite(ours).all() and (ours[:, 0] > 0).all()
    assert_within_ci(ours, jax_batched("balanced_pandas_pod", scenario="slow_rack"),
                     "balanced_pandas_pod on slow_rack: port vs JAX")
