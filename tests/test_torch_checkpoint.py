"""The port's checkpoints (``repro_torch.checkpoint``): the port versions
of ``tests/test_checkpoint.py:22-65`` (roundtrip, integrity, zlib codec,
GC, async save), the port's msgpack writer against ``msgpack`` itself, and
checkpoints crossing between the two packages in both directions with
every leaf byte-equal, bfloat16 included."""
import hashlib
import json
import os

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch

import repro.checkpoint.checkpoint as jckpt
from repro_torch import pytree
from repro_torch.checkpoint import checkpoint as ckpt
from _torch_train_cases import carried, cfgs, jax_state, opt_cfgs, single_thread

pytestmark = pytest.mark.usefixtures("single_thread")


def _tree(seed: int) -> dict:
    g = torch.Generator().manual_seed(seed)
    return {"layer": {"w": torch.randn(16, 8, generator=g),
                      "b": torch.zeros(8, dtype=torch.bfloat16)},
            "step": torch.tensor(7, dtype=torch.int32),
            "m": torch.randn(33, generator=g)}


def _bytes(t) -> bytes:
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def _jax_bytes(a) -> bytes:
    return np.asarray(a).tobytes()


def test_roundtrip_exact(tmp_path):
    tree = _tree(0)
    ckpt.save(str(tmp_path), 3, tree)
    restored, manifest = ckpt.restore(str(tmp_path), 3, tree)
    assert manifest["step"] == 3
    for a, b in zip(pytree.leaves(tree), pytree.leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_integrity_check_detects_corruption(tmp_path):
    tree = _tree(1)
    path = ckpt.save(str(tmp_path), 1, tree)
    blob = os.path.join(path, ckpt.data_filename(ckpt.DEFAULT_CODEC))
    payload = ckpt.unpackb(ckpt.decompress(open(blob, "rb").read(), ckpt.DEFAULT_CODEC))
    k = next(iter(payload))
    payload[k] = payload[k][:-1] + bytes([payload[k][-1] ^ 0xFF])
    with open(blob, "wb") as f:
        f.write(ckpt.compress(ckpt.packb(payload)))
    with pytest.raises(IOError, match="integrity"):
        ckpt.restore(str(tmp_path), 1, tree)


def test_zlib_codec_roundtrip_and_manifest(tmp_path):
    tree = _tree(3)
    path = ckpt.save(str(tmp_path), 5, tree, codec="zlib")
    assert os.path.exists(os.path.join(path, "data.msgpack.zlib"))
    restored, manifest = ckpt.restore(str(tmp_path), 5, tree)
    assert manifest["codec"] == "zlib"
    for a, b in zip(pytree.leaves(tree), pytree.leaves(restored)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="unknown checkpoint codec"):
        ckpt.save(str(tmp_path), 6, tree, codec="lz4")


def test_gc_keeps_last_n(tmp_path):
    tree = {"x": torch.zeros(4)}
    for s in range(6):
        ckpt.save(str(tmp_path), s, tree, keep=3)
    assert ckpt.find_all(str(tmp_path)) == [3, 4, 5]


def test_async_save_then_join_keeps_the_values_at_save_time(tmp_path):
    tree = _tree(2)
    before = {p: _bytes(t) for p, t in zip(*pytree.flatten_with_paths(tree)[:2])}
    ckpt.save(str(tmp_path), 9, tree, async_=True)
    tree["m"].add_(1.0)                    # the caller moves on at once
    ckpt.join_pending()
    assert ckpt.find_latest(str(tmp_path)) == 9
    restored, _ = ckpt.restore(str(tmp_path), 9, tree)
    paths, leaves, _ = pytree.flatten_with_paths(restored)
    assert {p: _bytes(t) for p, t in zip(paths, leaves)} == before


def test_restore_onto_shardings_waits_for_sharding(tmp_path):
    tree = {"x": torch.zeros(4)}
    ckpt.save(str(tmp_path), 1, tree)
    with pytest.raises(NotImplementedError, match="A.8.3"):
        ckpt.restore(str(tmp_path), 1, tree, shardings={"x": None})


@pytest.mark.parametrize("sizes", [(3, [0, 5, 31]), (40, [32, 255, 256]), (2, [65535, 65536]),
                                   (70000, [1])], ids=["fix", "str8-map16", "bin16-32",
                                                      "map32"])
def test_packb_equals_msgpack_and_unpackb_reads_it(sizes):
    n, lens = sizes
    rng = np.random.default_rng(n)
    payload = {}
    for i in range(n):
        key = ("k" * (lens[i % len(lens)] % 300)) + f"/{i}"
        payload[key] = rng.integers(0, 256, lens[i % len(lens)] if n < 100 else 1,
                                    dtype=np.uint8).tobytes()
    blob = ckpt.packb(payload)
    assert blob == msgpack.packb(payload, use_bin_type=True)
    assert ckpt.unpackb(blob) == payload == msgpack.unpackb(blob, raw=False)
    with pytest.raises(ValueError, match="trailing"):
        ckpt.unpackb(blob + b"\x00")


def _train_states(moment_dtype: str):
    cfgj, cfgt = cfgs()
    oj, _ = opt_cfgs(moment_dtype=moment_dtype)
    sj = jax_state(cfgj, oj)
    return sj, carried(sj, cfgt)


def test_train_state_leaf_paths_are_the_reference_strings():
    """A 2-layer smoke TrainState with int8 moments, saved with the
    pipeline state as the trainer saves it: 87 leaves, the reference's
    path strings in its order."""
    sj, st = _train_states("int8")
    pipe = {"step": np.int64(0), "seed": np.int64(0)}
    paths_j, _, _ = jckpt._tree_flatten_with_paths((sj, pipe))
    paths_t, _, _ = pytree.flatten_with_paths((st, pipe))
    assert len(paths_t) == 87 and paths_t == paths_j
    assert paths_t[0] == "[0]/.params/['embed']/['head']"
    assert "[0]/.opt/.v/['layers']/['mlp']/['w1']/[<flat index 0>]" in paths_t
    assert paths_t[-1] == "[1]/['step']"


@pytest.mark.parametrize("moment_dtype", ["int8", "bfloat16"])
def test_checkpoints_cross_between_the_packages(tmp_path, moment_dtype):
    """The port restores the reference's checkpoint and the reference the
    port's: every leaf byte-equal (bfloat16 params, and bfloat16 or int8
    moments), and both packages write the same manifest and payload."""
    sj, st = _train_states(moment_dtype)
    pipe = {"step": np.int64(4), "seed": np.int64(0)}
    d_ref, d_port = str(tmp_path / "ref"), str(tmp_path / "port")
    jckpt.save(d_ref, 4, (sj, pipe), extra={"arch": "x"}, codec="zlib")
    ckpt.save(d_port, 4, (st, pipe), extra={"arch": "x"}, codec="zlib")
    mj = json.load(open(os.path.join(d_ref, "step_00000004", "MANIFEST.json")))
    mt = json.load(open(os.path.join(d_port, "step_00000004", "MANIFEST.json")))
    assert mt == mj
    assert any(m["dtype"] == "bfloat16" for m in mt["leaves"].values())
    raw = [open(os.path.join(d, "step_00000004", "data.msgpack.zlib"), "rb").read()
           for d in (d_ref, d_port)]
    assert raw[0] == raw[1]

    # the reference's files into the port (onto a zeroed target) ...
    zeroed = pytree.tree_map(torch.zeros_like, st)
    (st2, pipe2), _ = ckpt.restore(d_ref, 4, (zeroed, {"step": 0, "seed": 0}))
    for (p, a), b in zip(zip(*pytree.flatten_with_paths(st)[:2]), pytree.leaves(st2)):
        assert a.dtype == b.dtype and _bytes(a) == _bytes(b), p
    assert {k: int(v) for k, v in pipe2.items()} == {"step": 4, "seed": 0}
    # ... and the port's into the reference
    (sj2, _), _ = jckpt.restore(d_port, 4, (sj, {"step": 0, "seed": 0}))
    for a, b in zip(jax.tree.leaves(sj), jax.tree.leaves(sj2)):
        assert a.dtype == b.dtype and _jax_bytes(a) == _jax_bytes(b)
    digest = {p: m["sha256"] for p, m in mt["leaves"].items()}
    paths, leaves, _ = pytree.flatten_with_paths(st2)
    for p, t in zip(paths, leaves):
        assert hashlib.sha256(_bytes(t)).hexdigest() == digest["[0]/" + p]
