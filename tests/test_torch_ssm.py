"""The port's recurrent blocks against the JAX reference's, on the CPU, at
the zamba2 (Mamba2) and rwkv6 smoke widths: ``mamba2_fwd`` /
``mamba2_decode`` and ``rwkv6_time_mix`` / ``rwkv6_time_mix_decode`` /
``rwkv6_channel_mix``.

Both packages run on the reference's parameters (numpy in between), with
the constant leaves (A_log, D, dt_bias; u, w0) drawn at random so that
each term counts.  The prefills run several chunks (S=32, chunk 8) from a
nonzero state, and return their final state; the decode steps go on from
the reference's state.  Outputs and states agree within 1e-5 of the
reference's largest magnitude in float32, and within one bfloat16 ulp
(2**-8) of it in bfloat16, against the reference as written op by op
(jitted with XLA's excess precision off: see ``_Ref``).  Also the port's
own prefill -> decode property: a prefill of S+3 tokens equals a prefill
of S followed by three decode steps, within 1e-4.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs as jconfigs
from repro.models import rwkv as jrk
from repro.models import ssm as jssm
import repro_torch.configs as tconfigs
import repro_torch.models as tm
from repro_torch.models import rwkv as trk
from repro_torch.models import ssm as tssm
from _torch_sim_helpers import one_thread

TOL = {"float32": 1e-5, "bfloat16": 2 ** -8}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPES = ["float32", "bfloat16"]
B, S, CHUNK, STEPS = 2, 32, 8, 3

pytestmark = pytest.mark.usefixtures("single_thread")


@pytest.fixture
def single_thread():
    with one_thread():
        yield


def _np(a) -> np.ndarray:
    a = jnp.asarray(a)
    return np.asarray(a.astype(jnp.float32) if a.dtype == jnp.bfloat16 else a)


def _pair(x: np.ndarray, dtype: str):
    """The same values in both packages, rounded to ``dtype`` once."""
    j = jnp.asarray(x).astype(dtype)
    return j, torch.from_numpy(_np(j).copy()).to(TDT[dtype])


def _err(port: torch.Tensor, ref) -> float:
    r = _np(ref).astype(np.float64)
    return float(np.abs(port.detach().to(torch.float64).numpy() - r).max() / np.abs(r).max())


class _Ref:
    """The reference's function, jitted with XLA's excess precision off
    (``xla_allow_excess_precision=False``): every bfloat16 rounding of the
    op-by-op program stays (its output equals the op-by-op run's), where
    XLA's default fusion drops some of them (measured: 1.2 ulp on
    mamba2).  One compile a signature."""

    def __init__(self, fn, static=(1,), **kw):
        self.jitted = jax.jit(functools.partial(fn, **kw), static_argnums=static)
        self.static, self.compiled = static, {}

    def __call__(self, *a, **kw):
        sig = str(jax.tree.map(lambda x: (x.shape, str(x.dtype)) if hasattr(x, "shape")
                               else x, (a, kw)))
        if sig not in self.compiled:
            self.compiled[sig] = self.jitted.lower(*a, **kw).compile(
                compiler_options={"xla_allow_excess_precision": False})
        return self.compiled[sig](*(x for i, x in enumerate(a) if i not in self.static), **kw)


@functools.cache
def _setup(arch: str, dtype: str):
    """(reference config, port config, reference params, port params):
    the reference's init with its constant leaves redrawn."""
    cfgj = jconfigs.get(arch, smoke=True).replace(dtype=dtype)
    cfgt = tconfigs.get(arch, smoke=True).replace(dtype=dtype)
    rng = np.random.default_rng(len(arch))
    if arch == "zamba2_2_7b":
        p = jax.tree.map(_np, jssm.mamba2_params(jax.random.PRNGKey(0), cfgj))
        H = cfgj.ssm_heads
        p.update(A_log=rng.normal(0, 0.5, H).astype(np.float32),
                 D=rng.uniform(0.5, 1.5, H).astype(np.float32),
                 dt_bias=rng.normal(-1.5, 0.5, H).astype(np.float32),
                 conv_b=rng.normal(0, 0.1, p["conv_b"].shape).astype(np.float32))
        f32 = ("A_log", "D", "dt_bias")
    else:
        p = jax.tree.map(_np, jrk.rwkv6_params(jax.random.PRNGKey(0), cfgj))
        p.update(u=rng.normal(0, 0.5, p["u"].shape).astype(np.float32),
                 w0=rng.normal(-0.6, 0.4, p["w0"].shape).astype(np.float32),
                 ln_scale=rng.uniform(0.5, 1.5, p["ln_scale"].shape).astype(np.float32))
        f32 = ("w0", "u", "ln_scale")
    pj = {k: (jax.tree.map(lambda a: jnp.asarray(a, dtype), v) if k not in f32
              else jnp.asarray(v)) for k, v in p.items()}
    pt = tm.params_from_numpy(jax.tree.map(_np, pj), dtype=TDT[dtype], device="cpu")
    return cfgj, cfgt, pj, pt


def _x(cfg, dtype: str, n: int, seed: int):
    return _pair(np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model)).astype(np.float32), dtype)


# ----------------------------------------------------------------------------
# Mamba2
# ----------------------------------------------------------------------------

_jfwd = _Ref(jssm.mamba2_fwd, chunk=CHUNK, return_state=True)
_jdec = _Ref(jssm.mamba2_decode)


def _ssm_state(cfgj, dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    conv = rng.standard_normal((B, cfgj.ssm_conv - 1, cfgj.ssm_inner + 2 * cfgj.ssm_state))
    st = rng.standard_normal((B, cfgj.ssm_heads, cfgj.ssm_state, cfgj.ssm_head_dim)) * 0.3
    cj, ct = _pair(conv.astype(np.float32), dtype)
    sj, sv = _pair(st.astype(np.float32), "float32")
    return jssm.SSMState(cj, sj), tssm.SSMState(ct, sv)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("start", ["fresh", "from-state"])
def test_mamba2_fwd_equals_the_reference(dtype, start):
    cfgj, cfgt, pj, pt = _setup("zamba2_2_7b", dtype)
    xj, xt = _x(cfgj, dtype, S, seed=1)
    sj, st = _ssm_state(cfgj, dtype, seed=2) if start == "from-state" else (None, None)
    oj, nj = _jfwd(pj, cfgj, xj, state=sj)
    ot, nt = tssm.mamba2_fwd(pt, cfgt, xt, chunk=CHUNK, state=st, return_state=True)
    assert ot.dtype == TDT[dtype] and nt.ssm.dtype == torch.float32
    assert nt.conv.dtype == TDT[dtype]
    assert _err(ot, oj) <= TOL[dtype]
    assert _err(nt.conv, nj.conv) <= TOL[dtype]
    assert _err(nt.ssm, nj.ssm) <= TOL[dtype]
    if start == "fresh":          # no state and the default chunk: the same output
        again = tssm.mamba2_fwd(pt, cfgt, xt)
        assert _err(again, oj) <= TOL[dtype]


@pytest.mark.parametrize("dtype", DTYPES)
def test_mamba2_decode_from_the_prefill_state_equals_the_reference(dtype):
    cfgj, cfgt, pj, pt = _setup("zamba2_2_7b", dtype)
    xj, _ = _x(cfgj, dtype, S, seed=3)
    _, sj = _jfwd(pj, cfgj, xj, state=None)
    st = tssm.SSMState(*(torch.from_numpy(_np(a).copy()).to(t.dtype) for a, t in
                         zip(sj, (torch.zeros(0, dtype=TDT[dtype]), torch.zeros(0)))))
    for i in range(STEPS):
        yj, yt = _x(cfgj, dtype, 1, seed=10 + i)
        oj, sj = _jdec(pj, cfgj, yj, sj)
        ot, st = tssm.mamba2_decode(pt, cfgt, yt, st)
        assert ot.shape == (B, 1, cfgt.d_model)
        assert _err(ot, oj) <= TOL[dtype]
        assert _err(st.conv, sj.conv) <= TOL[dtype] and _err(st.ssm, sj.ssm) <= TOL[dtype]


def test_mamba2_prefill_then_decode_equals_one_prefill():
    _, cfgt, _, pt = _setup("zamba2_2_7b", "float32")
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, S + STEPS, cfgt.d_model)).astype(np.float32))
    whole = tssm.mamba2_fwd(pt, cfgt, x, chunk=S + STEPS)
    out, st = tssm.mamba2_fwd(pt, cfgt, x[:, :S], chunk=CHUNK, return_state=True)
    outs = [out]
    for i in range(STEPS):
        o, st = tssm.mamba2_decode(pt, cfgt, x[:, S + i:S + i + 1], st)
        outs.append(o)
    got = torch.cat(outs, dim=1)
    assert float((got - whole).abs().max() / whole.abs().max()) < 1e-4


def test_init_ssm_state_equals_the_reference():
    cfgj, cfgt, _, _ = _setup("zamba2_2_7b", "bfloat16")
    a = jssm.init_ssm_state(cfgj, 3, jnp.bfloat16)
    b = tssm.init_ssm_state(cfgt, 3, torch.bfloat16, device="cpu")
    for x, y in zip(a, b):
        assert tuple(y.shape) == x.shape and str(y.dtype).split(".")[1] == str(x.dtype)
        assert (y == 0).all()


# ----------------------------------------------------------------------------
# RWKV-6
# ----------------------------------------------------------------------------

_jtm = _Ref(jrk.rwkv6_time_mix, chunk=CHUNK, return_state=True)
_jtmd = _Ref(jrk.rwkv6_time_mix_decode)
_jcm_shift = _Ref(jrk.rwkv6_channel_mix, static=(), return_shift=True)


def _rwkv_state(cfgj, dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    hd = cfgj.d_model // cfgj.n_heads
    wj, wt = _pair((rng.standard_normal((B, cfgj.n_heads, hd, hd)) * 0.3).astype(np.float32),
                   "float32")
    aj, at = _pair(rng.standard_normal((B, cfgj.d_model)).astype(np.float32), dtype)
    fj, ft = _pair(rng.standard_normal((B, cfgj.d_model)).astype(np.float32), dtype)
    return jrk.RWKVState(wj, aj, fj), trk.RWKVState(wt, at, ft)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("start", ["fresh", "from-state"])
def test_rwkv6_time_mix_equals_the_reference(dtype, start):
    cfgj, cfgt, pj, pt = _setup("rwkv6_7b", dtype)
    xj, xt = _x(cfgj, dtype, S, seed=5)
    sj, st = _rwkv_state(cfgj, dtype, seed=6) if start == "from-state" else (None, None)
    oj, nj = _jtm(pj, cfgj, xj, state=sj)
    ot, nt = trk.rwkv6_time_mix(pt, cfgt, xt, chunk=CHUNK, state=st, return_state=True)
    assert ot.dtype == TDT[dtype] and nt.wkv.dtype == torch.float32
    assert _err(ot, oj) <= TOL[dtype]
    assert _err(nt.wkv, nj.wkv) <= TOL[dtype]
    assert torch.equal(nt.shift_att, xt[:, -1]) and not nt.shift_ffn.any()


@pytest.mark.parametrize("dtype", DTYPES)
def test_rwkv6_decode_and_channel_mix_equal_the_reference(dtype):
    """From the prefill's state: three steps of the time-mix decode and
    the channel mix with its carried shift."""
    cfgj, cfgt, pj, pt = _setup("rwkv6_7b", dtype)
    xj, xt = _x(cfgj, dtype, S, seed=7)
    cj, shj = _jcm_shift(pj, xj)
    ct, sht = trk.rwkv6_channel_mix(pt, xt, return_shift=True)
    assert _err(ct, cj) <= TOL[dtype] and torch.equal(sht, xt[:, -1])
    _, sj = _jtm(pj, cfgj, xj, state=None)
    st = trk.RWKVState(torch.from_numpy(_np(sj.wkv).copy()), xt[:, -1], torch.zeros_like(xt[:, -1]))
    prev_j, prev_t = shj, sht
    for i in range(STEPS):
        yj, yt = _x(cfgj, dtype, 1, seed=20 + i)
        oj, sj = _jtmd(pj, cfgj, yj, sj)
        ot, st = trk.rwkv6_time_mix_decode(pt, cfgt, yt, st)
        assert _err(ot, oj) <= TOL[dtype] and _err(st.wkv, sj.wkv) <= TOL[dtype]
        assert torch.equal(st.shift_att, yt[:, 0])
        cj, prev_j = _jcm_shift(pj, yj, prev_j)
        ct, prev_t = trk.rwkv6_channel_mix(pt, yt, prev=prev_t, return_shift=True)
        assert _err(ct, cj) <= TOL[dtype]


def test_rwkv6_prefill_then_decode_equals_one_prefill():
    _, cfgt, _, pt = _setup("rwkv6_7b", "float32")
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(
        (B, S + STEPS, cfgt.d_model)).astype(np.float32))
    whole = trk.rwkv6_time_mix(pt, cfgt, x, chunk=S + STEPS)
    whole_c = trk.rwkv6_channel_mix(pt, x)
    out, st = trk.rwkv6_time_mix(pt, cfgt, x[:, :S], chunk=CHUNK, return_state=True)
    cm, shift = trk.rwkv6_channel_mix(pt, x[:, :S], return_shift=True)
    outs, cms = [out], [cm]
    for i in range(STEPS):
        xi = x[:, S + i:S + i + 1]
        o, st = trk.rwkv6_time_mix_decode(pt, cfgt, xi, st)
        c, shift = trk.rwkv6_channel_mix(pt, xi, prev=shift, return_shift=True)
        outs.append(o)
        cms.append(c)
    for got, want in ((torch.cat(outs, 1), whole), (torch.cat(cms, 1), whole_c)):
        assert float((got - want).abs().max() / want.abs().max()) < 1e-4


def test_init_rwkv_state_equals_the_reference():
    cfgj, cfgt, _, _ = _setup("rwkv6_7b", "bfloat16")
    a = jrk.init_rwkv_state(cfgj, 3, jnp.bfloat16)
    b = trk.init_rwkv_state(cfgt, 3, torch.bfloat16, device="cpu")
    for x, y in zip(a, b):
        assert tuple(y.shape) == x.shape and str(y.dtype).split(".")[1] == str(x.dtype)
        assert (y == 0).all()
