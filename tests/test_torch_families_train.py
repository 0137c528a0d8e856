"""One ``train_step`` of the moe, hybrid and ssm families (and of vlm,
whose loss reads the text positions only) in the port against the reference's
jitted ``train_step`` from the same state, on the CPU, float32, smoke
width: loss, grad norm and the MoE aux losses within 1e-5, and every
gradient leaf within 1e-5 of its largest magnitude, read from the first
moment after the step (m = (1 - b1) * clip * g), as
tests/test_torch_train.py does for the dense family.  The moe step reads
real aux losses (``LB_COEF`` / ``Z_COEF``); remat is on, as in the
configs."""
import jax
import numpy as np
import pytest

import repro.optim as jopt
import repro.train as jtrain
import repro_torch.models as tm
from repro_torch import pytree
from repro_torch.train import train_step
from _torch_family_cases import FAMILY_ARCHS, batch, cfgs, params, rel
from _torch_train_cases import jax_step, opt_cfgs, single_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("single_thread")

TOL = 1e-5


@pytest.mark.parametrize("family", ["moe", "hybrid", "ssm", "vlm"])
def test_train_step_equals_the_reference_from_the_same_state(family):
    cfgj, cfgt = cfgs(FAMILY_ARCHS[family], dtype="float32")
    oj, ot = opt_cfgs(lr=1e-2, warmup_steps=5, total_steps=100)
    pj, _ = params(cfgj, cfgt, seed=4)
    sj = jtrain.TrainState(params=pj, opt=jopt.init_opt_state(pj, oj))
    st = tm.train_state_from_numpy(jax.tree.map(np.asarray, sj), cfgt, device="cpu")
    bj, bt = batch(cfgj, 4, 16, seed=5, labels=True)
    sj2, mj = jax_step(cfgj, oj)(sj, bj)
    st2, mt = train_step(st, bt, cfg=cfgt, opt_cfg=ot)
    assert set(mt) == set(mj)
    for k in ("loss", "grad_norm", "lb_loss", "z_loss"):
        assert abs(float(mt[k]) - float(mj[k])) <= TOL * max(1.0, abs(float(mj[k]))), k
    assert (float(mj["lb_loss"]) > 0) == (family == "moe")
    for p, a, b in zip(pytree.flatten_with_paths(st2.opt.m)[0], pytree.leaves(st2.opt.m),
                       jax.tree.leaves(sj2.opt.m)):
        assert rel(a, b) < TOL, p
