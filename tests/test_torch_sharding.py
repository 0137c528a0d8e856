"""The port's sharding specs against the reference's (``models.sharding``,
the model modules' ``*_pspecs``, ``optim.opt_pspecs``, ``launch.specs``):
equal as tuples for every configuration of ``configs``, on the
single-pod and multi-pod meshes, under every rules table that
``rules_for`` gives a cell and that the dry run's ``VARIANTS`` add.  The
meshes are stand-ins with the production shapes: the specs read only the
axis names and sizes."""
import types

import jax
import numpy as np
import pytest

import repro.launch.specs as RS
import repro.models.sharding as RSh
import repro_torch.launch.specs as PS
import repro_torch.models.sharding as PSh
from repro.configs import get as rget
from repro.configs.base import ARCH_IDS, SHAPES
from repro.launch.dryrun import VARIANTS as RVARIANTS
from repro.models import param_pspecs as r_param_pspecs, cache_pspecs as r_cache_pspecs
from repro.models import init_params as r_init_params
from repro.optim.adamw import AdamWConfig as RAdamW, opt_pspecs as r_opt_pspecs
from repro_torch.configs import get as pget
from repro_torch.launch.dryrun import VARIANTS as PVARIANTS
from repro_torch.models import cache_pspecs as p_cache_pspecs, param_pspecs as p_param_pspecs
from repro_torch.optim.adamw import AdamWConfig as PAdamW, opt_pspecs as p_opt_pspecs

MESHES = {"pod": ((16, 16), ("data", "model")),
          "multipod": ((2, 16, 16), ("pod", "data", "model"))}
NAMES = sorted(RSh.BASE_RULES)


def _meshes(kind):
    shape, axes = MESHES[kind]
    ref = types.SimpleNamespace(axis_names=axes, devices=np.empty(shape),
                                shape=dict(zip(axes, shape)))
    return ref, types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def norm(x):
    """A spec tree as plain dicts and tuples (P -> tuple; QTensor specs,
    NamedTuples tagged with their type)."""
    if isinstance(x, dict):
        return {k: norm(v) for k, v in x.items()}
    if hasattr(x, "q") and hasattr(x, "log"):
        return ("QTensor", norm(x.q), norm(x.scale), norm(x.offset), x.log)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return (type(x).__name__, tuple(norm(v) for v in x))
    if isinstance(x, (tuple, jax.sharding.PartitionSpec)):
        return tuple(x)
    raise TypeError(type(x))


def _flat(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flat(v, prefix + (k,))
    else:
        yield prefix, tree


def test_placements_of_a_spec():
    """Each mesh dim a spec names is Shard(that tensor dim), in mesh
    order; a dim that lists axes out of mesh order raises."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"), shape=(2, 2, 2))
    assert PSh.placements(PSh.P(("pod", "data"), None, "model"), mesh) == \
        (Shard(0), Shard(0), Shard(2))
    assert PSh.placements(PSh.P(None, "data"), mesh) == (Replicate(), Shard(1), Replicate())
    assert PSh.placements(PSh.P(), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError):
        PSh.placements(PSh.P(("data", "pod")), mesh)
    ns = PSh.NamedSharding(mesh, PSh.P("model"))
    assert ns.placements == (Replicate(), Replicate(), Shard(0))
    assert PSh.P("a", None) == ("a", None) and repr(PSh.P("a", None)) == "P('a', None)"


def test_constrain_passes_plain_tensors_through():
    import torch
    x = torch.arange(6.0).reshape(2, 3)
    assert PSh.constrain(x, "batch", "vocab") is x


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference(arch):
    r_shapes = jax.eval_shape(lambda k: r_init_params(rget(arch), k), jax.random.PRNGKey(0))
    leaf_shapes = {p: tuple(v.shape) for p, v in _flat(r_shapes)}
    n = 0
    for kind in MESHES:
        rmesh, pmesh = _meshes(kind)
        for shape in SHAPES.values():
            for variant in RVARIANTS:
                r_over, c_over = RVARIANTS[variant]
                assert PVARIANTS[variant] == (r_over, c_over)
                rcfg, pcfg = rget(arch), pget(arch)
                if c_over:
                    rcfg, pcfg = rcfg.replace(**c_over), pcfg.replace(**c_over)
                rr = RS.rules_for(rcfg, shape, rmesh, extra=r_over)
                pr = PS.rules_for(pcfg, shape, pmesh, extra=r_over)
                assert pr == rr, (kind, shape.name, variant)
                for a in NAMES:
                    for b in (None, "batch", "embed_fsdp", "vocab"):
                        assert tuple(PSh.logical_pspec(a, b)) == tuple(RSh.logical_pspec(a, b))
                rp, pp = r_param_pspecs(rcfg), p_param_pspecs(pcfg)
                assert norm(pp) == norm(rp), (kind, shape.name, variant)
                assert norm(p_cache_pspecs(pcfg)) == norm(r_cache_pspecs(rcfg))
                for md in ("float32", "int8"):
                    assert norm(p_opt_pspecs(pp, PAdamW(moment_dtype=md))) == \
                        norm(r_opt_pspecs(rp, RAdamW(moment_dtype=md)))
                assert PS.opt_config_for(pcfg) == PAdamW(**vars(RS.opt_config_for(rcfg)))
                for path, spec in _flat(norm(pp)):
                    shp = leaf_shapes[path]
                    got = PS.sanitize_spec(PSh.P(*spec), shp, pmesh)
                    want = RS.sanitize_spec(jax.sharding.PartitionSpec(*spec), shp, rmesh)
                    assert tuple(got) == tuple(want), (path, spec, shp)
                    n += 1
    assert n > 0
