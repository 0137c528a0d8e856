"""``eager_slot_share.sim`` on traces built by hand: 1.0 with a step span
every slot, 0.0 with device operations and none, None without device
operations; and the span it reads is the program's."""
import pytest

from portbench import harness
from portbench import trace as tr


def _reader():
    name = "eager_slot_share.sim"
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", name)


def _trace(host, device=(("k", 10.0, 20.0),), slots=4):
    return tr.Trace((0.0, 1000.0), list(device), sorted(host, key=lambda e: e[1]), slots, {})


def _slot(t0):
    """One eager slot's spans from ``t0``."""
    return [("sim.draws", t0, t0 + 10), ("sim.step.service", t0 + 10, t0 + 20),
            ("sim.step.schedule", t0 + 20, t0 + 40), ("sim.step.route", t0 + 40, t0 + 60),
            ("sim.step.accumulate", t0 + 60, t0 + 80)]


def test_a_step_span_every_slot_reads_one():
    host = [e for t0 in (100.0, 300.0, 500.0, 700.0) for e in _slot(t0)]
    assert _reader().read(_trace(host)) == 1.0


def test_replayed_slots_read_zero():
    host = [("sim.draws", 50.0, 400.0), ("sim.draws.fill", 60.0, 300.0),
            ("aten::copy_", 310.0, 320.0)]
    assert _reader().read(_trace(host)) == 0.0


def test_an_eager_tail_reads_its_share():
    host = [("sim.draws", 50.0, 400.0)] + _slot(500.0)
    assert _reader().read(_trace(host)) == pytest.approx(0.25)


def test_spans_outside_the_window_do_not_count():
    host = _slot(500.0) + [("sim.step.service", 1200.0, 1210.0)]
    assert _reader().read(_trace(host)) == pytest.approx(0.25)


def test_no_device_operation_reads_none():
    host = [e for t0 in (100.0, 300.0) for e in _slot(t0)]
    assert _reader().read(_trace(host, device=())) is None
    assert _reader().read(tr.Trace((0.0, 1.0), [], [], 1, {})) is None


def test_the_span_read_is_the_programs():
    from repro_torch.spans import SPANS
    assert _reader().SPAN in SPANS
