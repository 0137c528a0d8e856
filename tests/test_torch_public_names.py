"""The port keeps the reference's public names and argument lists
(ROADMAP C.3), so one test can call both packages.

Every module of ``repro`` has its counterpart in ``repro_torch`` or is
listed in ``NOT_PORTED`` with the ROADMAP item that ports it.  For each
pair: the reference's public names (functions and classes defined there,
upper-case constants, and everything a package ``__init__`` exports)
exist in the port, the public members of each class too, and each
function's parameters are the reference's, in order, with the port's own
additions after them.  The differences that are by design are listed in
one place, below.
"""
import importlib
import inspect
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import repro
import repro_torch
from repro.core import Cluster as JCluster
from repro.core import Rates as JRates
from repro_torch.core import Cluster, Rates

# modules of the reference the port does not have, and why
NOT_PORTED = {
    "kernels.ops": "by design: only the Pallas interpret defaults; its "
                   "public names are the port's kernels/__init__ exports",
}

# by design: no trace counters (nothing is traced); no Pallas layout
# constants or interpret switch
_PALLAS = {"resolve_interpret", "FLAG_BASE", "LANE", "WIDTH", "SUB"}
MISSING_BY_DESIGN = {
    "core": {"trace_count", "reset_trace_count"},
    "core.simulator": {"trace_count", "reset_trace_count"},
    "trace.replay": {"replay_trace_count", "reset_replay_trace_count"},
    "kernels.invrates": _PALLAS,
    "kernels.pod_route": _PALLAS,
    "kernels.queue_update": _PALLAS,
    "kernels.route_commit": _PALLAS,
    "kernels.weighted_argmin": _PALLAS,
    # a parser of XLA's compiled HLO text: the port makes none
    "launch.dryrun": {"parse_collective_bytes"},
}
# by design, the port's own names where JAX has GSPMD: its PartitionSpec
# and NamedSharding, the spec -> DTensor placements map, the current mesh
# a mesh-axis collective resolves against, and the dry run's fake world
PORT_ONLY = {
    "models.sharding": {"P", "NamedSharding", "placements", "mesh_axes", "even_spec",
                        "to_spec", "use_mesh", "current_mesh", "sharded_region",
                        "resolve_grad", "note_gather", "GATHERS"},
    "launch.specs": {"shard_tree"},
    "launch.mesh": {"production_shape"},
    "launch.dryrun": {"StepCounter", "fake_world", "trace_step", "trace_cell",
                      "local_bytes", "greedy"},
}
# launcher flags that differ by design: --device picks the card or the
# CPU; --save-hlo writes XLA's HLO, which the port does not make
FLAGS_ADDED = {"launch.train": {"--device"}, "launch.serve": {"--device"},
               "launch.dryrun": set()}
FLAGS_DROPPED = {"launch.train": set(), "launch.serve": set(),
                 "launch.dryrun": {"--save-hlo"}}
# the dry run's record: XLA's compiled-artifact fields have no counterpart;
# the port records its traced cost and its gathers instead
RECORD_DROPPED = {"cost_xla_flat", "collectives_flat", "hlo_lines"}
RECORD_ADDED = {"cost", "notes"}
# the reference's draw key is a torch.Generator (``gen``) or the routing
# draws (``rnd``) at the draw seams; Pallas knobs come in as ``**kw``
RENAMED = {"key": ("key", "gen", "rnd")}
# signatures that differ by design
SIGNATURE_BY_DESIGN = {
    # the port's wrapper names the operands the reference passes as **kw,
    # and its plain version takes them as **kw
    ("kernels", "route_commit"), ("kernels.ref", "route_commit_ref"),
}


def _modules(pkg) -> set:
    """Every module under the package's directory (``launch/`` has no
    ``__init__``), dotted, without the package's own name."""
    root = Path(list(pkg.__path__)[0])
    out = set()
    for f in root.rglob("*.py"):
        parts = f.relative_to(root).with_suffix("").parts
        parts = parts[:-1] if parts[-1] == "__init__" else parts
        if parts:
            out.add(".".join(parts))
    return out


def _public(mod) -> dict:
    is_pkg = hasattr(mod, "__path__")
    out = {}
    for k, v in vars(mod).items():
        if k.startswith("_") or inspect.ismodule(v):
            continue
        if inspect.isfunction(v) or inspect.isclass(v):
            if is_pkg or v.__module__ == mod.__name__:
                out[k] = v
        elif k.isupper() or is_pkg:
            out[k] = v
    return out


def _params(fn) -> list:
    if inspect.isclass(fn):
        fn = fn.__init__
    try:
        ps = inspect.signature(fn).parameters.values()
    except (TypeError, ValueError):
        return None
    return [p.name for p in ps if p.kind != p.VAR_KEYWORD]


PAIRS = sorted(_modules(repro) & _modules(repro_torch))


def test_every_reference_module_is_ported_or_listed():
    assert _modules(repro) - _modules(repro_torch) == set(NOT_PORTED)


@pytest.mark.parametrize("name", PAIRS)
def test_public_names_and_parameters_equal_the_reference(name):
    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    pr, pp = _public(ref), _public(port)
    assert set(pr) - set(pp) <= MISSING_BY_DESIGN.get(name, set())
    for k in sorted(set(pr) & set(pp)):
        a, b = pr[k], pp[k]
        if inspect.isclass(a) and inspect.isclass(b):
            members = {m for m in vars(a) if not m.startswith("_")}
            assert members <= set(dir(b)), (k, sorted(members - set(dir(b))))
        if not (callable(a) and callable(b)) or (name, k) in SIGNATURE_BY_DESIGN:
            continue
        ra, rb = _params(a), _params(b)
        if ra is None or rb is None:
            continue
        assert len(rb) >= len(ra), (k, ra, rb)
        for x, y in zip(ra, rb):
            assert y in RENAMED.get(x, (x,)), (k, ra, rb)


def test_mean_slots_and_same_rack_equal_the_reference():
    """ROADMAP C.3: the two members the port lacked."""
    rates = Rates(0.04, 0.02, 0.008)
    got = rates.mean_slots()
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), np.asarray(JRates(0.04, 0.02, 0.008).mean_slots()))
    for M, K in ((20, 4), (12, 3), (6, 6)):
        same = Cluster(M, K).same_rack
        assert same.dtype == torch.bool and same.shape == (M, M)
        assert same.device == Cluster(M, K).rack_of.device
        np.testing.assert_array_equal(same.numpy(), np.asarray(JCluster(M, K).same_rack))


@pytest.mark.parametrize("name", sorted(PORT_ONLY))
def test_the_ports_own_names_exist(name):
    port = importlib.import_module(f"repro_torch.{name}")
    assert PORT_ONLY[name] <= set(vars(port))


_FLAG = re.compile(r"add_argument\(\s*\"(--[a-z0-9-]+)\"")


@pytest.mark.parametrize("name", sorted(FLAGS_ADDED))
def test_launcher_flags_equal_the_reference(name):
    def flags(pkg):
        return set(_FLAG.findall(Path(importlib.import_module(f"{pkg}.{name}").__file__)
                                 .read_text()))
    ref, port = flags("repro"), flags("repro_torch")
    assert port == (ref - FLAGS_DROPPED[name]) | FLAGS_ADDED[name]


def test_dryrun_record_fields_by_design():
    def fields(pkg):
        text = Path(importlib.import_module(f"{pkg}.launch.dryrun").__file__).read_text()
        return set(re.findall(r'rec\["([a-z_]+)"\]', text))
    ref, port = fields("repro"), fields("repro_torch")
    assert RECORD_DROPPED <= ref and not RECORD_DROPPED & port
    assert port == (ref - RECORD_DROPPED) | RECORD_ADDED
