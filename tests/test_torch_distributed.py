"""The port's multi-rank collectives on CPU process groups (gloo, one
process a rank, joined through a FileStore under tmp_path;
``_torch_dist``): the int8-wire ring all-reduce and the GPipe forward
against the reference's (run under ``shard_map`` on fake XLA devices in a
subprocess, as ``tests/test_distributed.py`` runs them)."""
import os
import subprocess
import sys

import numpy as np

from _torch_dist import run_ranks

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _reference(code: str, devices: int, *args, timeout: float = 120) -> str:
    env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={devices}",
               JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                       timeout=timeout, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return r.stdout


_REF_RING = r"""
import sys; sys.path.insert(0, "src")
import jax, numpy as np
from jax.sharding import PartitionSpec as P
from jax.experimental.shard_map import shard_map
from repro.train import ring_allreduce_q8
x = np.load(sys.argv[1])
mesh = jax.make_mesh((x.shape[0],), ("pod",))
f = shard_map(lambda s: ring_allreduce_q8(s[0], "pod")[None],
              mesh=mesh, in_specs=P("pod", None), out_specs=P("pod", None))
np.save(sys.argv[2], np.asarray(f(x)))
"""


def test_ring_allreduce_q8_equals_the_reference_and_sends_int8(tmp_path):
    """8 ranks: every rank's sum equals the reference's row for that
    shard bit for bit, is within the reference's own 5% of the exact sum,
    and every payload sent is int8 or a one-element float32 scale."""
    x = (np.random.default_rng(0).standard_normal((8, 1000)) * 2).astype(np.float32)
    np.save(tmp_path / "x.npy", x)
    _reference(_REF_RING, 8, str(tmp_path / "x.npy"), str(tmp_path / "ref.npy"))
    ref = np.load(tmp_path / "ref.npy")
    res = run_ranks("ring", 8, tmp_path, timeout=120, x_path=str(tmp_path / "x.npy"))
    want = x.sum(axis=0)
    for r, (got, sent) in enumerate(res):
        np.testing.assert_array_equal(got, ref[r])
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        assert rel < 0.05, rel
        assert sent and all(dt == "torch.int8" or (dt == "torch.float32" and n == 1)
                            for dt, n in sent), sent
        assert sum(dt == "torch.int8" for dt, _ in sent) == 2 * (8 - 1)


_REF_PIPE = r"""
import sys; sys.path.insert(0, "src")
import jax, jax.numpy as jnp, numpy as np
from repro.train import pipeline_forward
d = np.load(sys.argv[1])
mesh = jax.make_mesh((int(sys.argv[3]),), ("pod",))
layer = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
out = pipeline_forward(layer, {"w": d["W"], "b": d["b"]}, d["x"], mesh=mesh, n_micro=4)
np.save(sys.argv[2], np.asarray(out))
"""


def test_pipeline_forward_equals_the_scan_and_the_reference(tmp_path):
    """4 stages, L=8, D=16, B=8, 4 microbatches: every rank's output is
    the sequential loop's within 1e-5 and the reference's within 1e-6."""
    rng = np.random.default_rng(0)
    L, D, B = 8, 16, 8
    inputs = {"W": (rng.standard_normal((L, D, D)) * 0.2).astype(np.float32),
              "b": (rng.standard_normal((L, D)) * 0.1).astype(np.float32),
              "x": rng.standard_normal((B, D)).astype(np.float32)}
    np.savez(tmp_path / "pipe.npz", **inputs)
    _reference(_REF_PIPE, 4, str(tmp_path / "pipe.npz"), str(tmp_path / "ref.npy"), "4")
    ref = np.load(tmp_path / "ref.npy")
    res = run_ranks("pipeline", 4, tmp_path, timeout=120,
                    inputs_path=str(tmp_path / "pipe.npz"), n_micro=4)
    for out, seq in res:
        assert np.abs(out - seq).max() < 1e-5
        assert np.abs(out - ref).max() < 1e-6


def test_pipeline_forward_one_stage(tmp_path):
    """A 1-stage pipeline is the sequential loop."""
    rng = np.random.default_rng(1)
    inputs = {"W": (rng.standard_normal((4, 8, 8)) * 0.2).astype(np.float32),
              "b": (rng.standard_normal((4, 8)) * 0.1).astype(np.float32),
              "x": rng.standard_normal((4, 8)).astype(np.float32)}
    np.savez(tmp_path / "pipe.npz", **inputs)
    (out, seq), = run_ranks("pipeline", 1, tmp_path, timeout=60,
                            inputs_path=str(tmp_path / "pipe.npz"), n_micro=2)
    np.testing.assert_array_equal(out, seq)
