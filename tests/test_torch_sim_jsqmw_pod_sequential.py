"""Level-3 parity inside the port: the sequential route mode (per-arrival
join-the-shortest-local-queue, random ties) against the batched one (the
route_commit path, ties by replica slot) for jsq_maxweight_pod, six seeds
each (see _torch_sim_helpers.py)."""
import numpy as np

from _torch_sim_helpers import SEEDS, assert_within_ci, port


def test_sequential_mode_agrees_with_batched_within_seed_ci():
    seq = port("jsq_maxweight_pod", "sequential", range(SEEDS))
    bat = port("jsq_maxweight_pod", "batched", range(SEEDS, 2 * SEEDS))
    assert np.isfinite(seq).all() and np.isfinite(bat).all()
    assert_within_ci(seq, bat, "jsq_maxweight_pod: sequential vs batched")
