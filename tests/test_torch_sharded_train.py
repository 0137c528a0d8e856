"""A sharded train_step (params, moments and batch as DTensors on a (2, 2)
("data", "model") mesh of 4 gloo ranks, ``param_specs`` given,
``dispatch_groups`` = the data axis' size as the dry run sets it) against
the unsharded port step from the same state, in float32, for the dense
and the MoE smoke configs.

Tolerances: the loss, the aux losses and the grad norm within 1e-5
(relative); every gradient, read from the first moment after the step
(m = (1 - b1) * clip * g), and every second moment within 1e-5 of its
leaf's largest magnitude; every updated parameter within 1e-5 wherever
its gradient is above 1e-6 in magnitude.  Adam's first update is
lr * g / (|g| + eps) with eps = 1e-8: where |g| is within a few hundred
eps, the last bits of g, which the sharded sums add in another order,
move the update by up to 2 lr, so those entries are held to 2 lr, and
the ones more than 1e-5 apart are counted (printed with -s)."""
import numpy as np
import pytest

from _torch_dist import run_ranks


@pytest.mark.parametrize("arch,fsdp", [("llama3_8b", False), ("deepseek_moe_16b", False)])
def test_sharded_train_step_equals_the_unsharded_step(arch, fsdp, tmp_path):
    check_sharded_step(arch, fsdp, tmp_path)


def check_sharded_step(arch, fsdp, tmp_path):
    """The comparison of the module docstring, on 4 ranks."""
    res = run_ranks("sharded_train_step", 4, tmp_path, timeout=150, arch=arch,
                    mesh_shape=(2, 2), fsdp=fsdp)
    r = res[0]
    assert r["kept"]
    for other in res[1:]:              # every rank holds the same full state
        for p in r["sharded"]:
            np.testing.assert_array_equal(other["sharded"][p], r["sharded"][p])
    for k, (got, want) in r["metrics"].items():
        assert abs(got - want) <= 1e-5 * max(abs(want), 1e-30), (k, got, want)
    lr, b1 = r["lr"], r["b1"]
    loose = 0
    for p, want in r["plain"].items():
        got = r["sharded"][p]
        scale = max(float(np.abs(want).max()), 1e-30)
        if not p.startswith(".params"):
            assert np.abs(got - want).max() <= 1e-5 * scale, p
            continue
        m = r["plain"][p.replace(".params", ".opt/.m", 1)]
        g = np.abs(m) / (1 - b1)               # clip <= 1 only shrinks it
        tight = g > 1e-6
        assert np.abs(got - want)[tight].max(initial=0) <= 1e-5, p
        assert np.abs(got - want).max() <= 2 * lr, p
        loose += int((np.abs(got - want) > 1e-5).sum())
    placed = r["placements"]
    assert "Shard(dim=1)" in placed["['embed']/['head']"]         # vocab over model
    if arch == "deepseek_moe_16b":
        assert "Shard(dim=1)" in placed["['layers']/['moe']/['w1']"]   # experts over model
    print(f"{arch}: {loose} parameter entries more than 1e-5 apart, all with |g| <= 1e-6")
