"""ZeRO-3 sharded train steps on a (2, 2) ("data", "model") mesh of 4 gloo
ranks: kimi-k2's smoke config with its production ZeRO-3 (params and
moments sharded over data, gathered a layer at a time) against the
unsharded step, with ``test_torch_sharded_train``'s tolerances; and int8
moments under ZeRO-3 keeping their layout."""
import numpy as np

from _torch_dist import run_ranks
from test_torch_sharded_train import check_sharded_step


def test_zero3_sharded_train_step_equals_the_unsharded_step(tmp_path):
    check_sharded_step("kimi_k2_1t_a32b", True, tmp_path)


def test_sharded_step_with_int8_moments_keeps_its_layout(tmp_path):
    """ZeRO-3 with int8 moments (kimi-k2's production optimizer) on the
    llama smoke config, whose 64-wide last axes are padded to one block:
    the blocking gathers them, every new leaf keeps its old placements,
    and loss and grad norm are the unsharded step's within 1e-5; the
    parameters move within 2 lr of it (the quantized moments differ by
    whole codes where a block's sums round otherwise)."""
    (r, *_) = run_ranks("sharded_train_step", 4, tmp_path, timeout=150, arch="llama3_8b",
                        mesh_shape=(2, 2), fsdp=True, moments="int8")
    assert r["kept"]
    for k in ("loss", "grad_norm"):
        got, want = r["metrics"][k]
        assert abs(got - want) <= 1e-5 * abs(want), (k, got, want)
    for p, want in r["plain"].items():
        if p.startswith(".params"):
            assert np.abs(r["sharded"][p] - want).max() <= 2 * r["lr"], p
