"""The port's optimizer, gradient compression and data pipeline
(``repro_torch.optim``, ``repro_torch.train.compression``,
``repro_torch.data``) against the JAX reference's, on the CPU.

Same inputs in both packages.  What cannot be bit-exact, and how it is
compared: ``cosine_lr``'s cosine (XLA's float32 cos and PyTorch's differ
by an ulp, and ``1 + cos`` near the end of the schedule cancels it up to
a few ulps of the value) within one float32 ulp of ``cfg.lr`` against the
reference evaluated op by op, equal to the bit during warmup (the jitted
reference itself differs from its op-by-op evaluation by up to 1.25 ulps
of ``lr``: XLA fuses the expression); int8 moments, whose codes may differ
by one at a rounding boundary (``log`` differs by an ulp), within one
quantization step once dequantized; bfloat16 leaves within one bfloat16
ulp.  ``apply_update`` is given identical inputs in both packages.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.data as jdata
import repro.optim.adamw as ja
import repro.train as jtrain
import repro_torch.data as tdata
import repro_torch.models as tm
import repro_torch.optim.adamw as ta
import repro_torch.train as ttrain
from repro_torch import pytree
from _torch_train_cases import carried, cfgs, jax_state, np_, opt_cfgs, rel, single_thread

pytestmark = pytest.mark.usefixtures("single_thread")

STEPS = np.arange(0, 121)
SCHEDULES = [dict(lr=3e-4, warmup_steps=5, total_steps=100),
             dict(lr=1e-2, warmup_steps=10, total_steps=60),
             dict(lr=1.0, warmup_steps=0, total_steps=120, min_lr_frac=0.0)]


def _bits(a: np.ndarray) -> np.ndarray:
    return np.asarray(a, np.float32).view(np.int32).astype(np.int64)


@pytest.mark.parametrize("kw", SCHEDULES, ids=["smoke", "example", "no-warmup"])
def test_cosine_lr_within_one_ulp_of_lr(kw):
    oj, ot = opt_cfgs(**kw)
    ref = np.array([np.asarray(ja.cosine_lr(oj, jnp.int32(i))) for i in STEPS], np.float32)
    jit = np.asarray(jax.jit(jax.vmap(lambda s: ja.cosine_lr(oj, s)))(jnp.asarray(STEPS, jnp.int32)))
    got = ta.cosine_lr(ot, torch.from_numpy(STEPS.astype(np.int32)))
    assert got.dtype == torch.float32
    got = got.numpy()
    ulp = float(np.spacing(np.float32(kw["lr"])))
    assert np.abs(got - ref).max() <= ulp
    assert np.abs(got - jit).max() <= 2 * ulp
    warm = STEPS <= kw["warmup_steps"]
    np.testing.assert_array_equal(_bits(got[warm]), _bits(ref[warm]))


def test_round_is_half_to_even_in_both_packages():
    halves = np.arange(-6, 7, dtype=np.float32) + 0.5
    np.testing.assert_array_equal(torch.round(torch.from_numpy(halves)).numpy(),
                                  np.asarray(jnp.round(jnp.asarray(halves))))
    # a block whose scale is exactly 1: the linear codes are the rounded halves
    x = np.concatenate([[127.0], halves, np.zeros(128 - 1 - halves.size)]).astype(np.float32)
    qj = ja._quantize(jnp.asarray(x), log=False)
    qt = ta._quantize(torch.from_numpy(x), log=False)
    assert float(qt.scale.reshape(())) == 1.0 == float(qj.scale.reshape(()))
    np.testing.assert_array_equal(qt.q.numpy(), np.asarray(qj.q))


def _step(t, log: bool) -> np.ndarray:
    """One quantization step of each element of a QTensor's blocks
    ([..., n_blk * 128]), from its scale: the largest step in the block."""
    s = np_(t.scale)[..., 0]
    if not log:
        return np.repeat(s, 128, axis=-1)
    x = np.exp(np_(t.offset)[..., 0] + 254 * s)        # the block's largest
    return np.repeat(x * (np.exp(s) - 1), 128, axis=-1)


@pytest.mark.parametrize("log", [False, True], ids=["linear", "log"])
@pytest.mark.parametrize("shape", [(3, 200), (2, 5, 128), (7,), ()])
def test_quantize_dequantize_within_one_step_of_the_reference(log, shape):
    rng = np.random.default_rng(len(shape) + log)
    x = np.asarray(rng.standard_normal(shape), np.float32) * np.float32(0.01)
    if log:
        x = x * x
    qj = ja._quantize(jnp.asarray(x), log)
    qt = ta._quantize(torch.tensor(x), log)
    assert qt.log == qj.log
    for a, b in ((qt.q, qj.q), (qt.scale, qj.scale), (qt.offset, qj.offset)):
        assert tuple(a.shape) == b.shape and str(a.dtype).split(".")[1] == str(b.dtype)
    assert np.abs(qt.q.numpy().astype(int) - np.asarray(qj.q).astype(int)).max() <= 1
    assert rel(qt.scale, qj.scale) < 1e-6
    dj = np.asarray(ja._dequantize(qj, shape, x.size))
    dt = ta._dequantize(qt, shape, x.size).numpy()
    step = _step(qj, log)[..., :shape[-1] if shape else 1].reshape(shape)
    assert dt.shape == dj.shape
    assert (np.abs(dt - dj) <= step * (1 + 1e-5)).all()
    assert (np.abs(dt - x) <= step).all()


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_init_opt_state_has_the_reference_structure(moment_dtype):
    cfgj, cfgt = cfgs()
    oj, ot = opt_cfgs(moment_dtype=moment_dtype)
    sj = jax.eval_shape(lambda k: jtrain.init_train_state(cfgj, oj, k), jax.random.PRNGKey(0))
    st = ttrain.init_train_state(cfgt, ot, 0, device="cpu")
    flat_j = jax.tree_util.tree_leaves_with_path(sj)
    paths, leaves, _ = pytree.flatten_with_paths(st)
    assert paths == ["/".join(str(k) for k in p) for p, _ in flat_j]
    for t, (_, a) in zip(leaves, flat_j):
        assert tuple(t.shape) == a.shape and str(t.dtype).split(".")[1] == str(a.dtype)
    for m in pytree.leaves(st.opt, is_leaf=lambda x: isinstance(x, ta.QTensor))[1:]:
        d = ta._decode(m, torch.zeros(1), moment_dtype) if moment_dtype != "int8" else \
            ta._dequantize(m, tuple(m.q.shape[:-2]) + (m.q.shape[-2] * 128,), 0)
        assert (d == 0).all()


def _within_bf16_ulp(port, ref) -> bool:
    """Each element within one bfloat16 ulp of the larger of the two, plus
    1e-5 of the leaf's largest magnitude: the float32 values both packages
    round to bfloat16 differ by float32 rounding, which a cancellation
    (``b1 * m + (1 - b1) * g`` near 0) makes large next to the result."""
    a, b = np_(port), np_(ref)
    return bool((np.abs(a - b) <= np.maximum(np.abs(a), np.abs(b)) * 2 ** -7
                 + 1e-5 * np.abs(b).max()).all())


def _random_grads(params_j, rng):
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32) * 0.01).astype(p.dtype), params_j)


@pytest.mark.parametrize("moment_dtype", ["float32", "bfloat16", "int8"])
def test_apply_update_equals_the_reference_given_identical_inputs(moment_dtype):
    """From a state three updates in (moments not zero), one more update in
    each package: params within one bfloat16 ulp, moments within float32
    rounding (float32), one bfloat16 ulp, or one quantization step (int8),
    grad norm and lr within 1e-6."""
    cfgj, cfgt = cfgs()
    oj, ot = opt_cfgs(lr=1e-2, warmup_steps=5, total_steps=100, moment_dtype=moment_dtype)
    sj = jax_state(cfgj, oj)
    upd = jax.jit(lambda p, g, o: ja.apply_update(p, g, o, oj))
    rng = np.random.default_rng(0)
    params, opt = sj.params, sj.opt
    for _ in range(3):
        params, opt, _ = upd(params, _random_grads(params, rng), opt)
    st = carried(jtrain.TrainState(params, opt), cfgt)
    g = _random_grads(params, rng)
    gt = tm.params_from_numpy(jax.tree.map(np.asarray, g), dtype=torch.bfloat16, device="cpu")
    pj, oj2, mj = upd(params, g, opt)
    pt, ot2, mt = ta.apply_update(st.params, gt, st.opt, ot)
    assert int(ot2.step) == int(oj2.step) == 4 and ot2.step.dtype == torch.int32
    assert rel(mt["grad_norm"], mj["grad_norm"]) < 1e-5 and rel(mt["lr"], mj["lr"]) < 1e-6
    for a, b in zip(pytree.leaves(pt), jax.tree.leaves(pj)):
        assert a.dtype == torch.bfloat16
        assert _within_bf16_ulp(a, b)
    is_q = lambda x: isinstance(x, (ja.QTensor, ta.QTensor))
    for log, mt_, mj_ in ((False, ot2.m, oj2.m), (True, ot2.v, oj2.v)):
        for a, b, p in zip(pytree.leaves(mt_, is_leaf=is_q), jax.tree.leaves(mj_, is_leaf=is_q),
                           jax.tree.leaves(params)):
            if moment_dtype == "int8":
                da = ta._dequantize(a, tuple(p.shape), p.size).numpy()
                db = np.asarray(ja._dequantize(b, p.shape, p.size))
                step = _step(b, log)[..., :p.shape[-1] if p.ndim else 1].reshape(p.shape)
                # one step, and 1e-3 of one for the two packages' scales,
                # which differ by float32 rounding (measured 1.1e-5 of a step)
                assert (np.abs(da - db) <= step * (1 + 1e-3)).all()
            elif moment_dtype == "bfloat16":
                assert a.dtype == torch.bfloat16
                assert _within_bf16_ulp(a, b)
            else:
                assert rel(a, b) < 1e-5


def test_global_norm_equals_the_reference():
    cfgj, cfgt = cfgs()
    sj = jax_state(cfgj, opt_cfgs()[0])
    st = carried(sj, cfgt)
    assert rel(ta.global_norm(st.params), ja.global_norm(sj.params)) < 1e-5


@pytest.mark.parametrize("shape", [(1000,), (64, 33), (5,)])
def test_ef_encode_equals_the_reference(shape):
    from repro.train import compression as jc
    x = np.random.default_rng(7).standard_normal(shape).astype(np.float32) * 3
    ej = jc.ef_encode(jnp.asarray(x))
    et = ttrain.ef_encode(torch.from_numpy(x))
    np.testing.assert_array_equal(et.q.numpy(), np.asarray(ej.q))
    np.testing.assert_array_equal(et.scale.numpy(), np.asarray(ej.scale))
    assert (et.shape, et.size) == (ej.shape, ej.size)
    dec = ttrain.ef_decode(et)
    np.testing.assert_array_equal(dec.numpy(), np.asarray(jc.ef_decode(ej)))
    assert float((dec - torch.from_numpy(x)).abs().max() / abs(x).max()) < 0.02


def test_ring_allreduce_q8_waits_for_sharding(tmp_path):
    """Since sharding landed: outside a current mesh the ring raises (the
    axis name resolves against nothing); over an axis of one rank it
    returns its input.  The 8-rank ring against the reference is
    tests/test_torch_distributed.py's."""
    with pytest.raises(RuntimeError, match="no current mesh"):
        ttrain.ring_allreduce_q8(torch.zeros(4), "pod")
    from _torch_dist import run_ranks
    (same,) = run_ranks("ring_axis_one", 1, tmp_path, timeout=60)
    assert same


@pytest.mark.parametrize("kw", [dict(vocab=1024, seq_len=64, global_batch=8),
                                dict(vocab=128256, seq_len=32, global_batch=4, seed=3,
                                     n_hosts=2, host_id=1)])
def test_synthetic_lm_batches_equal_the_reference(kw):
    pj = jdata.SyntheticLM(jdata.PipelineConfig(**kw))
    pt = tdata.SyntheticLM(tdata.PipelineConfig(**kw))
    for _ in range(6):
        bj, bt = pj.next_batch(), pt.next_batch()
        for k in ("tokens", "labels"):
            assert bt[k].dtype == bj[k].dtype
            np.testing.assert_array_equal(bt[k], bj[k])
    state = pt.state()
    assert state == pj.state() == {"step": 6, "seed": kw.get("seed", 0)}
    again = tdata.SyntheticLM(tdata.PipelineConfig(**kw))
    again.restore({"step": 3, "seed": state["seed"]})
    pj.restore({"step": 3, "seed": state["seed"]})
    for _ in range(2):
        np.testing.assert_array_equal(again.next_batch()["tokens"], pj.next_batch()["tokens"])
