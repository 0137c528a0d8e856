"""The port's training substrate (``repro_torch.train``) on the CPU: the
port versions of ``tests/test_train.py:33-114`` (convergence, microbatch
and compression parity, int8 moments, bitwise resume, a crash mid-save),
and ``train_step``'s metrics and gradients against the reference's jitted
``train_step`` from the same carried state (float32 smoke config; the
gradients read from the first moment after step 1, m = (1 - b1) * g *
clip, within 1e-5 of each leaf's largest magnitude; loss and grad norm
within 1e-5; with int8 error feedback in the accumulator, a code may flip
at a rounding boundary: the gradients within one code, 1/127 of the
leaf's largest magnitude (measured 4.6e-3), loss and grad norm within
1e-3)."""
import os

import jax
import numpy as np
import pytest
import torch

from repro_torch import pytree
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.configs import get
from repro_torch.data import PipelineConfig, SyntheticLM
from repro_torch.optim import AdamWConfig
from repro_torch.train import (Trainer, TrainerConfig, ef_decode, ef_encode,
                               init_train_state, train_step)
from _torch_train_cases import batch, carried, cfgs, jax_state, jax_step, opt_cfgs, rel, single_thread

pytestmark = pytest.mark.usefixtures("single_thread")

CFG = get("llama3_8b", smoke=True)
OCFG = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100)


def _pipe(seed=0, batch=8):
    return SyntheticLM(PipelineConfig(vocab=CFG.vocab, seq_len=64,
                                      global_batch=batch, seed=seed))


def _losses(state, steps: int, opt_cfg=OCFG, **kw) -> list:
    pipe, out = _pipe(), []
    for _ in range(steps):
        state, m = train_step(state, pipe.next_batch(), cfg=CFG, opt_cfg=opt_cfg, **kw)
        out.append(float(m["loss"]))
    return out


def test_loss_decreases():
    losses = _losses(init_train_state(CFG, OCFG, 0, device="cpu"), 30)
    assert losses[-1] < losses[0] - 1.0


def test_microbatch_equals_full_batch_gradients():
    """Accumulated microbatch gradients == one big batch (same data)."""
    state = init_train_state(CFG, OCFG, 0, device="cpu")
    b = _pipe().next_batch()
    s1, _ = train_step(state, b, cfg=CFG, opt_cfg=OCFG, microbatches=1)
    s2, _ = train_step(state, b, cfg=CFG, opt_cfg=OCFG, microbatches=4)
    worst = max(float((a.float() - c.float()).abs().max())
                for a, c in zip(pytree.leaves(s1.params), pytree.leaves(s2.params)))
    assert worst < 2e-2, worst   # bf16 params; microbatch sums reorder adds
    # the step is functional: the state it was given is left as it was
    again, _ = train_step(state, b, cfg=CFG, opt_cfg=OCFG, microbatches=1)
    for a, c in zip(pytree.leaves(s1.params), pytree.leaves(again.params)):
        assert torch.equal(a, c)


def test_ef_compression_roundtrip_and_parity():
    x = torch.randn(1000, generator=torch.Generator().manual_seed(0)) * 3
    dec = ef_decode(ef_encode(x))
    assert float((x - dec).abs().max() / x.abs().max()) < 0.02
    losses = _losses(init_train_state(CFG, OCFG, 0, device="cpu"), 25,
                     microbatches=2, grad_compress=True)
    assert losses[-1] < losses[0] - 1.0


def test_int8_optimizer_moments_converge():
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100, moment_dtype="int8")
    losses = _losses(init_train_state(CFG, ocfg, 0, device="cpu"), 25, opt_cfg=ocfg)
    assert losses[-1] < losses[0] - 1.0


def test_failure_recovery_resume_is_bitwise(tmp_path):
    """Train 20 steps straight vs train-crash@13-resume@12: identical
    losses (params + optimizer + data cursor all checkpointed)."""
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    quiet = dict(log_fn=lambda s: None, device="cpu")
    tcfg = TrainerConfig(total_steps=20, ckpt_every=6, ckpt_dir=d1,
                         log_every=100, async_ckpt=False)
    ref = Trainer(CFG, OCFG, tcfg, _pipe(), **quiet).run()["losses"]

    tcfg2 = TrainerConfig(total_steps=20, ckpt_every=6, ckpt_dir=d2,
                          log_every=100, async_ckpt=True, fail_at_step=13)
    t2 = Trainer(CFG, OCFG, tcfg2, _pipe(), **quiet)
    with pytest.raises(RuntimeError, match="injected failure"):
        t2.run()
    # "new process": a fresh trainer auto-resumes from the step 12 checkpoint
    tcfg3 = TrainerConfig(total_steps=20, ckpt_every=6, ckpt_dir=d2,
                          log_every=100, async_ckpt=False)
    t3 = Trainer(CFG, OCFG, tcfg3, _pipe(), **quiet)
    assert t3.start_step == 12 and t3.pipeline.step == 12
    out = t3.run()
    np.testing.assert_array_equal(np.array(ref[12:]), np.array(out["losses"]))
    assert len(out["step_times"]) == 8
    # the final checkpoint restores the final state byte for byte
    (state, _), manifest = ckpt.restore(d2, 20, (t3.state, {"step": 0, "seed": 0}))
    assert manifest["extra"] == {"arch": CFG.name}
    for a, b in zip(pytree.leaves(t3.state), pytree.leaves(state)):
        assert a.dtype == b.dtype and torch.equal(a, b)


_FIRST_STEP = r"""
import gc, sys, weakref
sys.path.insert(0, "src")
gc.disable()                     # what stays alive must not wait for gc
import torch
torch.set_num_threads(1)
from repro_torch import pytree
from repro_torch.configs import get
from repro_torch.data import PipelineConfig, SyntheticLM
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_train_state, train_step
cfg = get("llama3_8b", smoke=True)
assert cfg.remat
for moments, mb in (("float32", 1), ("int8", 2)):
    ocfg = AdamWConfig(moment_dtype=moments)
    state = init_train_state(cfg, ocfg, 0, device="cpu")
    refs = [weakref.ref(t) for t in pytree.leaves(state)]
    batch = SyntheticLM(PipelineConfig(vocab=cfg.vocab, seq_len=16, global_batch=4)).next_batch()
    new, _ = train_step(state, batch, cfg=cfg, opt_cfg=ocfg, microbatches=mb)
    del state
    print(moments, sum(r() is not None for r in refs))
"""


def test_a_step_keeps_no_old_state_alive():
    """The process's first train_step (in a fresh interpreter, gc off)
    frees the state it was given once the caller drops it: no reference
    cycle and no lazy import's frames hold the old params or moments."""
    import subprocess
    import sys
    r = subprocess.run([sys.executable, "-c", _FIRST_STEP], capture_output=True, text=True,
                       timeout=300, cwd=os.path.dirname(os.path.dirname(__file__)))
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.split() == ["float32", "0", "int8", "0"], r.stdout


def test_crash_mid_save_is_harmless(tmp_path):
    """A half-written checkpoint dir (no manifest) is never picked up."""
    d = str(tmp_path)
    tree = {"w": torch.arange(8.0)}
    ckpt.save(d, 5, tree)
    os.makedirs(os.path.join(d, "step_00000009"))
    with open(os.path.join(d, "step_00000009", "data.msgpack.zst"), "wb") as f:
        f.write(b"garbage")
    assert ckpt.find_latest(d) == 5
    step, restored, _ = ckpt.restore_latest(d, tree)
    assert step == 5 and torch.equal(restored["w"], tree["w"])


def test_entry_points_need_a_card_unless_told_otherwise():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(CFG, OCFG, 0)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(CFG, OCFG, TrainerConfig(total_steps=1), _pipe(), log_fn=lambda s: None)


@pytest.mark.parametrize("kw,tol,tol_grads", [
    (dict(), 1e-5, 1e-5), (dict(microbatches=4), 1e-5, 1e-5),
    (dict(microbatches=2, grad_compress=True), 1e-3, 1 / 127)],
    ids=["mb1", "mb4", "mb2-ef"])
def test_train_step_equals_the_reference_from_the_same_state(kw, tol, tol_grads):
    cfgj, cfgt = cfgs(dtype="float32")
    oj, ot = opt_cfgs(lr=1e-2, warmup_steps=5, total_steps=100)
    sj = jax_state(cfgj, oj)
    st = carried(sj, cfgt)
    b = batch(cfgj, 8, 64, seed=6)
    sj2, mj = jax_step(cfgj, oj, **kw)(sj, b)
    st2, mt = train_step(st, b, cfg=cfgt, opt_cfg=ot, **kw)
    assert set(mt) == set(mj)
    for k in ("loss", "grad_norm"):
        assert rel(mt[k], mj[k]) < tol, k
    assert float(mt["lr"]) == float(mj["lr"]) and int(st2.opt.step) == 1
    for p, a, b_ in zip(pytree.flatten_with_paths(st2.opt.m)[0], pytree.leaves(st2.opt.m),
                        jax.tree.leaves(sj2.opt.m)):
        assert rel(a, b_) < tol_grads, p
