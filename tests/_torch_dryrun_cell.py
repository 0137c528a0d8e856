"""One dry-run cell of the port in a process of its own (as the
reference's dry-run tests run theirs), and the argument bytes that the
reference's own specs give that cell's rank 0."""
import functools
import json
import math
import os
import subprocess
import sys
import types

import jax
import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CELL = r"""
import json, sys, tempfile
sys.path.insert(0, "src")
from repro_torch.launch.dryrun import run_cell
rec = run_cell(sys.argv[1], sys.argv[2], sys.argv[3], tempfile.mkdtemp())
print("DRYRUN " + json.dumps(rec))
"""


def run_port_cell(mesh: str, arch: str, shape: str, kind: str, timeout: float = 240) -> dict:
    env = dict(os.environ, REPRO_TEST_MESH=mesh)
    r = subprocess.run([sys.executable, "-c", _CELL, arch, shape, kind], capture_output=True,
                       text=True, timeout=timeout, cwd=ROOT, env=env)
    lines = [l for l in r.stdout.splitlines() if l.startswith("DRYRUN ")]
    assert r.returncode == 0 and lines, (r.stdout[-1000:], r.stderr[-3000:])
    return json.loads(lines[-1][len("DRYRUN "):])


def reference_argument_bytes(mesh: str, arch: str, shape_name: str, kind: str) -> int:
    """Rank 0's argument bytes by the reference's rules_for, param_pspecs,
    opt_pspecs, cache_pspecs and sanitize_spec over jax.eval_shape's
    shapes, on a stand-in of the mesh (names and sizes; nothing compiled)."""
    import repro.launch.specs as RS
    from repro.configs import get
    from repro.configs.base import SHAPES
    from repro.models import cache_pspecs, init_cache, init_params, param_pspecs
    from repro.models.sharding import logical_pspec
    from repro.optim.adamw import opt_pspecs
    from repro.train.train_step import TrainState, init_train_state

    dims = tuple(int(x) for x in mesh.split("x"))
    axes = ("pod", "data", "model") if kind == "multipod" else ("data", "model")
    stand = types.SimpleNamespace(axis_names=axes, devices=np.empty(dims),
                                  shape=dict(zip(axes, dims)))
    cfg, shape = get(arch), SHAPES[shape_name]
    RS.rules_for(cfg, shape, stand)
    key = jax.random.PRNGKey(0)
    B, S = shape.global_batch, shape.seq_len
    pairs = []
    if shape.kind == "train":
        ocfg = RS.opt_config_for(cfg)
        sds = jax.eval_shape(functools.partial(init_train_state, cfg, ocfg), key)
        specs = TrainState(params=param_pspecs(cfg), opt=opt_pspecs(param_pspecs(cfg), ocfg))
        pairs.append((sds, specs))
        tok = jax.ShapeDtypeStruct((B, S), np.int32)
        pairs.append(({"t": tok, "l": tok}, {"t": logical_pspec("batch", None),
                                             "l": logical_pspec("batch", None)}))
    else:
        pairs.append((jax.eval_shape(functools.partial(init_params, cfg), key), param_pspecs(cfg)))
        pairs.append((jax.eval_shape(functools.partial(init_cache, cfg, B, S)), cache_pspecs(cfg)))
        pairs.append(({"t": jax.ShapeDtypeStruct((B, 1), np.int32),
                       "p": jax.ShapeDtypeStruct((B,), np.int32)},
                      {"t": logical_pspec("batch", None), "p": logical_pspec("batch")}))
    total = [0]

    def add(sds, spec):
        spec = RS.sanitize_spec(spec, sds.shape, stand)
        local = [d // RS._axis_size(stand, a) for d, a in
                 zip(sds.shape, tuple(spec) + (None,) * (len(sds.shape) - len(spec)))]
        total[0] += math.prod(local) * np.dtype(sds.dtype).itemsize

    for sds, specs in pairs:
        jax.tree.map(add, sds, specs, is_leaf=lambda x: False)
    return total[0]
