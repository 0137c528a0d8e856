"""Fault-tolerant checkpointing (PyTorch mirror of
``repro.checkpoint.checkpoint``): msgpack + zstd/zlib leaves, atomic
manifest, content hashes, async save.

Layout of one checkpoint, the reference's to the byte, so that each package
restores the other's files:
    <dir>/step_000123/
        data.msgpack.zst      leaf payloads: one msgpack map of leaf path ->
                              raw bytes (.zlib when zstandard is missing;
                              the codec is recorded in the manifest and
                              restore dispatches on it)
        MANIFEST.json         step, codec, shapes/dtypes, sha256s, extra

Leaf paths are ``pytree.flatten_with_paths``'s: JAX's keystr strings.  A
bfloat16 leaf goes to disk as its raw 2-byte words under the dtype string
"bfloat16" and comes back the same way (numpy has no bfloat16).  The one
msgpack form the format uses (a map of str keys to bin values) is written
and read here (``packb`` / ``unpackb``), so the port needs no msgpack.

Guarantees:
  - Atomicity: everything is written into step_xxx.tmp.<pid> and renamed
    into place only after fsync; a crash mid-save never corrupts the latest
    valid checkpoint (restore scans for the newest dir WITH a manifest).
  - Integrity: per-leaf sha256 recorded and verified on restore.
  - Async: save() copies every leaf to the host before it returns and can
    write in a background thread; join_pending() fences.
Restoring onto other shardings waits for sharding (ROADMAP A.8.3).
"""
from __future__ import annotations

import hashlib
import json
import os
import shutil
import struct
import threading
import zlib
from typing import Any, Optional

import numpy as np
import torch

from .. import pytree

try:  # optional: ~3x faster + denser than zlib, but not in every image
    import zstandard as zstd
except ImportError:
    zstd = None

DEFAULT_CODEC = "zstd" if zstd is not None else "zlib"
_CODEC_EXT = {"zstd": "zst", "zlib": "zlib"}


def _check_codec(codec: str) -> None:
    if codec not in _CODEC_EXT:
        raise ValueError(f"unknown checkpoint codec {codec!r}")
    if codec == "zstd" and zstd is None:
        raise RuntimeError("zstandard not installed; use codec='zlib'")


def compress(blob: bytes, codec: str = DEFAULT_CODEC) -> bytes:
    _check_codec(codec)
    if codec == "zstd":
        return zstd.ZstdCompressor(level=3).compress(blob)
    return zlib.compress(blob, level=6)


def decompress(blob: bytes, codec: str) -> bytes:
    if codec == "zstd" and zstd is None:
        raise RuntimeError(
            "checkpoint was written with zstd but zstandard is not "
            "installed; `pip install zstandard` to restore it")
    _check_codec(codec)
    if codec == "zstd":
        return zstd.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def data_filename(codec: str) -> str:
    return f"data.msgpack.{_CODEC_EXT[codec]}"


# ---------------------------------------------------------------------------
# msgpack: a map of str keys to bin values
# ---------------------------------------------------------------------------

# (largest length, prefix byte, struct format of the length) for each form
_MAP = ((15, 0x80, None), (0xFFFF, 0xDE, ">H"), (0xFFFFFFFF, 0xDF, ">I"))
_STR = ((31, 0xA0, None), (0xFF, 0xD9, ">B"), (0xFFFF, 0xDA, ">H"),
        (0xFFFFFFFF, 0xDB, ">I"))
_BIN = ((0xFF, 0xC4, ">B"), (0xFFFF, 0xC5, ">H"), (0xFFFFFFFF, 0xC6, ">I"))


def _head(forms, n: int) -> bytes:
    """The smallest form's header for length ``n``."""
    for most, prefix, fmt in forms:
        if n <= most:
            return bytes([prefix | n]) if fmt is None else \
                bytes([prefix]) + struct.pack(fmt, n)
    raise ValueError(f"length {n} too large for msgpack")


def packb(payload: dict) -> bytes:
    """``msgpack.packb(payload, use_bin_type=True)`` of a dict of str keys
    to bytes values, byte for byte."""
    parts = [_head(_MAP, len(payload))]
    for key, raw in payload.items():
        k = key.encode("utf-8")
        parts += [_head(_STR, len(k)), k, _head(_BIN, len(raw)), bytes(raw)]
    return b"".join(parts)


def _read_len(buf: memoryview, at: int, forms) -> tuple:
    """(length, offset after the header) of the form at ``buf[at]``."""
    b = buf[at]
    for most, prefix, fmt in forms:
        if fmt is None and prefix <= b <= prefix | most:
            return b & most, at + 1
        if fmt is not None and b == prefix:
            size = struct.calcsize(fmt)
            return struct.unpack(fmt, buf[at + 1:at + 1 + size])[0], at + 1 + size
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x} at {at}")


def unpackb(blob: bytes) -> dict:
    """The dict of a msgpack map of str keys to bin values (what
    ``msgpack.unpackb(blob, raw=False)`` gives for it)."""
    buf = memoryview(blob)
    n, at = _read_len(buf, 0, _MAP)
    out = {}
    for _ in range(n):
        size, at = _read_len(buf, at, _STR)
        key = bytes(buf[at:at + size]).decode("utf-8")
        size, at = _read_len(buf, at + size, _BIN)
        out[key] = bytes(buf[at:at + size])
        at += size
    if at != len(buf):
        raise ValueError(f"{len(buf) - at} trailing bytes after the msgpack map")
    return out


# ---------------------------------------------------------------------------
# leaves
# ---------------------------------------------------------------------------


def _host(x) -> np.ndarray:
    """A leaf as a C-contiguous numpy array on the host, copied now; a
    bfloat16 tensor as its int16 words."""
    if isinstance(x, torch.Tensor):
        t = x.detach().to("cpu", copy=True).contiguous()
        return t.view(torch.int16).numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.array(x, order="C")            # keeps a 0-d leaf 0-d


def _dtype_name(x, arr: np.ndarray) -> str:
    if isinstance(x, torch.Tensor) and x.dtype == torch.bfloat16:
        return "bfloat16"
    return str(arr.dtype)


def _leaf(raw: bytes, meta: dict, like) -> torch.Tensor:
    """A stored leaf as a tensor: in ``like``'s dtype and on its device when
    ``like`` is a tensor, else as stored, on the CPU."""
    bf16 = meta["dtype"] == "bfloat16"
    arr = np.frombuffer(raw, dtype=np.int16 if bf16 else meta["dtype"])
    t = torch.from_numpy(arr.reshape(meta["shape"]).copy())
    if bf16:
        t = t.view(torch.bfloat16)
    if isinstance(like, torch.Tensor):
        return t.to(device=like.device, dtype=like.dtype)
    return t


_PENDING: list[threading.Thread] = []


def save(directory: str, step: int, tree: Any, extra: Optional[dict] = None,
         async_: bool = False, keep: int = 3,
         codec: str = DEFAULT_CODEC) -> str:
    """Write checkpoint; returns the final path."""
    _check_codec(codec)   # fail in the caller, not the async writer thread
    paths, leaves, _ = pytree.flatten_with_paths(tree)
    host_leaves = [_host(x) for x in leaves]
    dtypes = [_dtype_name(x, a) for x, a in zip(leaves, host_leaves)]

    final = os.path.join(directory, f"step_{step:08d}")

    def _write():
        tmp = final + f".tmp.{os.getpid()}"
        os.makedirs(tmp, exist_ok=True)
        payload = {}
        manifest_leaves = {}
        for p, arr, dt in zip(paths, host_leaves, dtypes):
            raw = arr.tobytes()
            payload[p] = raw
            manifest_leaves[p] = {
                "shape": list(arr.shape),
                "dtype": dt,
                "sha256": hashlib.sha256(raw).hexdigest(),
            }
        comp = compress(packb(payload), codec)
        with open(os.path.join(tmp, data_filename(codec)), "wb") as f:
            f.write(comp)
            f.flush()
            os.fsync(f.fileno())
        manifest = {"step": step, "codec": codec, "leaves": manifest_leaves,
                    "extra": extra or {}}
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        _gc(directory, keep)

    if async_:
        t = threading.Thread(target=_write, daemon=True)
        t.start()
        _PENDING.append(t)
    else:
        _write()
    return final


def join_pending() -> None:
    while _PENDING:
        _PENDING.pop().join()


def _gc(directory: str, keep: int) -> None:
    steps = sorted(find_all(directory))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(directory, f"step_{s:08d}"),
                      ignore_errors=True)


def find_all(directory: str) -> list[int]:
    """All steps with a complete (manifest-bearing) checkpoint."""
    if not os.path.isdir(directory):
        return []
    out = []
    for name in os.listdir(directory):
        if name.startswith("step_") and not name.count(".tmp"):
            if os.path.exists(os.path.join(directory, name, "MANIFEST.json")):
                out.append(int(name.split("_")[1]))
    return sorted(out)


def find_latest(directory: str) -> Optional[int]:
    steps = find_all(directory)
    return steps[-1] if steps else None


def restore(directory: str, step: int, target: Any,
            shardings: Optional[Any] = None, verify: bool = True) -> Any:
    """Restore into the structure of ``target`` (a tree of tensors or
    Python scalars): each leaf a tensor, in its target's dtype and on its
    device when the target is a tensor.  Returns (tree, manifest).
    ``shardings`` must be None: placement onto a mesh waits for sharding
    (ROADMAP A.8.3)."""
    if shardings is not None:
        raise NotImplementedError("restoring onto shardings waits for "
                                  "sharding (ROADMAP A.8.3)")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "MANIFEST.json")) as f:
        manifest = json.load(f)
    codec = manifest.get("codec", "zstd")   # pre-codec manifests were zstd
    with open(os.path.join(path, data_filename(codec)), "rb") as f:
        payload = unpackb(decompress(f.read(), codec))

    paths, leaves, unflatten = pytree.flatten_with_paths(target)
    out = []
    for p, like in zip(paths, leaves):
        meta = manifest["leaves"][p]
        raw = payload[p]
        if verify and hashlib.sha256(raw).hexdigest() != meta["sha256"]:
            raise IOError(f"checkpoint leaf {p} failed integrity check")
        out.append(_leaf(raw, meta, like))
    return unflatten(out), manifest


def restore_latest(directory: str, target: Any, shardings=None):
    step = find_latest(directory)
    if step is None:
        return None
    tree, manifest = restore(directory, step, target, shardings)
    return step, tree, manifest
