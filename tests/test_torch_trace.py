"""The port's trace layers against the JAX reference (``repro.trace``).

The ingest and compile layers are numpy copies, so they are held equal:
ArrivalLog round trips (JSONL and npz, each package reading what the other
wrote), schema validation, streaming slot batches, ``synth_trace`` and
``production_day`` array for array, ``catalog_plan``, ``arrival_rows`` and
``fit_size_sigma``, and ``scenario_from_trace`` -> ``realize`` bit-equal
to the reference's with and without the canonical pad (the capacity edge
within 1e-9 relative: the fluid LP runs in each package).  The
``production_day`` entry sits at the reference's registry index.
"""
import dataclasses

import numpy as np
import pytest

from repro.core import cluster as jcl
from repro.scenarios import build as jbuild
from repro.scenarios import spec as jspec
from repro import trace as jtrace
from repro_torch import trace as ttrace
from repro_torch.core import cluster as tcl
from repro_torch.scenarios import build as tbuild
from repro_torch.scenarios import spec as tspec


def small_log(pkg, n=400, seed=3, **kw):
    kw.setdefault("churn_t", (0.5,))
    kw.setdefault("n_tenants", 2)
    kw.setdefault("n_chunks", 64)
    return pkg.synth_trace(name="small", n_tasks=n, seed=seed, **kw)


def assert_logs_equal(a, b):
    assert (a.schema, a.name, a.horizon, a.churn_t) == (b.schema, b.name, b.horizon,
                                                        b.churn_t)
    for col in ("t", "chunk", "size", "tenant"):
        x, y = getattr(a, col), getattr(b, col)
        assert (x is None) == (y is None), col
        if x is not None:
            assert x.dtype == y.dtype, col
            np.testing.assert_array_equal(x, y, err_msg=col)


@pytest.mark.parametrize("kw", [{}, dict(n_flash=0, churn_t=(), n_tenants=0),
                                dict(diurnal_amp=0.8, churn_t=(0.2, 0.6, 0.9),
                                     size_sigma=0.9, zipf_s=1.4)])
def test_synth_and_production_day_equal_the_reference(kw):
    assert_logs_equal(small_log(ttrace, **kw), small_log(jtrace, **kw))
    for n, seed in ((3000, 7), (1234, 11)):
        assert_logs_equal(ttrace.production_day(n, seed), jtrace.production_day(n, seed))
    assert ttrace.production_day(500) is ttrace.production_day(500)      # cached


def test_encodings_round_trip_across_packages(tmp_path):
    log = small_log(ttrace)
    for ext, write, read in (("jsonl", ttrace.write_jsonl, jtrace.read_jsonl),
                             ("npz", ttrace.write_npz, jtrace.read_npz)):
        p = tmp_path / f"a.{ext}"
        write(log, p)
        assert_logs_equal(ttrace.load(p), log)
        assert_logs_equal(read(p), log)
        q = tmp_path / f"b.{ext}"
        getattr(jtrace, f"write_{ext}")(jtrace.load(p), q)
        assert_logs_equal(ttrace.load(q), log)
    with pytest.raises(ValueError, match="extension"):
        ttrace.load(tmp_path / "a.csv")


def test_validation_and_slot_batches_equal_the_reference(tmp_path):
    log = small_log(ttrace)
    jlog = small_log(jtrace)
    bads = [dict(t=log.t[::-1].copy()), dict(schema="repro.trace/v0"),
            dict(size=-log.size), dict(churn_t=(0.8, 0.2)), dict(chunk=log.chunk[:-3])]
    assert ttrace.validate_log(log) == []
    for bad in bads:
        jbad = {k: (np.asarray(v) if isinstance(v, np.ndarray) else v)
                for k, v in bad.items()}
        got = ttrace.validate_log(dataclasses.replace(log, **bad))
        assert got and got == jtrace.validate_log(dataclasses.replace(jlog, **jbad))
        with pytest.raises(ValueError, match="invalid arrival log"):
            ttrace.ensure_valid(dataclasses.replace(log, **bad))
    p = tmp_path / "s.jsonl"
    ttrace.write_jsonl(log, p)
    for T, B in ((64, 20), (100, 7)):
        ours = list(ttrace.iter_slot_batches(log, T, B))
        theirs = list(jtrace.iter_slot_batches(jlog, T, B))
        stream = list(ttrace.stream_slot_batches(p, T, B))
        assert len(ours) == len(theirs) == len(stream) == -(-T // B)
        for a, b, c in zip(ours, theirs, stream):
            assert a.slot0 == b.slot0 == c.slot0
            for f in ("counts", "slot", "chunk", "size", "tenant"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
                np.testing.assert_array_equal(getattr(a, f), getattr(c, f), err_msg=f)
    np.testing.assert_array_equal(log.slot_counts(77), jlog.slot_counts(77))
    np.testing.assert_array_equal(log.epoch_of(), jlog.epoch_of())


@pytest.mark.parametrize("budget", [3, 48, 400])
def test_catalog_plan_rows_and_size_fit_equal_the_reference(budget):
    log, jlog = small_log(ttrace, n=2000, n_chunks=256), small_log(jtrace, n=2000, n_chunks=256)
    plans, jplans = ttrace.catalog_plan(log, budget), jtrace.catalog_plan(jlog, budget)
    assert len(plans) == len(jplans)
    for a, b in zip(plans, jplans):
        assert a.n_tail == b.n_tail and a.row0 == b.row0
        np.testing.assert_array_equal(a.head_ids, b.head_ids)
        np.testing.assert_array_equal(a.mass, b.mass)
    np.testing.assert_array_equal(ttrace.arrival_rows(log, budget),
                                  jtrace.arrival_rows(jlog, budget))
    assert ttrace.fit_size_sigma(log) == jtrace.fit_size_sigma(jlog)
    with pytest.raises(ValueError, match="budget"):
        ttrace.catalog_plan(log, 1)


def _realized_equal(tscen, jscen, label):
    for name, a, b in zip(tbuild.ScenarioData._fields, tscen, jscen):
        assert (a is None) == (b is None), (label, name)
        if a is not None:
            np.testing.assert_array_equal(a.cpu().numpy(), np.asarray(b),
                                          err_msg=f"{label}: {name}")


@pytest.mark.parametrize("padded", [False, True], ids=["unpadded", "canonical_pad"])
def test_scenario_from_trace_realizes_as_the_reference(padded):
    M, K = 16, 4
    cl_t, cl_j = tcl.Cluster(M=M, K=K), jcl.Cluster(M=M, K=K)
    r_t, r_j = tcl.Rates(0.05, 0.025, 0.01), jcl.Rates(0.05, 0.025, 0.01)
    tpad = tbuild.canonical_pad(cl_t) if padded else None
    jpad = jbuild.canonical_pad(cl_j) if padded else None
    cases = [(ttrace.scenario_from_trace(small_log(ttrace), seed=5),
              jtrace.scenario_from_trace(small_log(jtrace), seed=5)),
             (ttrace.scenario_from_trace(ttrace.production_day(5000), chunks_per_server=2),
              jtrace.scenario_from_trace(jtrace.production_day(5000), chunks_per_server=2)),
             (tspec.get_scenario("production_day"), jspec.get_scenario("production_day"))]
    for ts, js in cases:
        assert ts.name == js.name and ts.sizes.sigma == js.sizes.sigma
        tscen, tcap = tbuild.realize(ts, cl_t, r_t, 300, tpad, device="cpu")
        jscen, jcap = jbuild.realize(js, cl_j, r_j, 300, pad=jpad)
        _realized_equal(tscen, jscen, ts.name)
        assert tcap == pytest.approx(jcap, rel=1e-9, abs=0), ts.name
    # the duck-typed hooks see the real trace: churn epochs on the slot grid
    scen, _ = tbuild.realize("production_day", cl_t, r_t, 128, tpad, device="cpu")
    assert set(scen.placement_epoch.tolist()) == {0, 1, 2}
    assert float(scen.size_sigma) == pytest.approx(0.35, abs=0.01)


def test_production_day_is_registered_at_the_reference_index():
    names = tspec.scenario_names()
    assert names == jspec.scenario_names()
    assert names.index("production_day") == jspec.scenario_names().index("production_day")
    assert tspec.registry_limits() == jspec.registry_limits()
    assert tuple(tbuild.canonical_pad(tcl.Cluster(M=8, K=2))) == \
        tuple(jbuild.canonical_pad(jcl.Cluster(M=8, K=2)))
    assert ttrace.SCHEMA == jtrace.SCHEMA
