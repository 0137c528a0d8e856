"""Trace replay: ingest -> compile -> replay (PyTorch mirror of
``repro.trace``).

Three layers over one versioned arrival-log format (format.SCHEMA):

  ingest    ``format``: ArrivalLog (JSONL and packed-npz round trips),
            ``validate_log`` and streaming slot-batch readers; ``synth``:
            production-shaped traces (diurnal x flash crowds x placement
            churn, Zipf popularity, lognormal sizes).
  compile   ``compile.scenario_from_trace``: lower a log onto the scenario
            axes (binned lam_shape, a placement catalog a churn epoch
            inside the canonical pad, the fitted size law).
  replay    ``replay.ReplayEngine``: a recorded arrival log served through
            the ``route_commit`` kernel, chunk by chunk, with the copy of
            the next chunk to the card overlapping the current chunk's
            slots.  Imported lazily: it needs the simulator, which this
            package must not load while the scenario registry imports it.

The numpy layers are copies of the reference's.  The canonical production
day registers as the ``production_day`` scenario, at the registry index the
reference gives it.
"""
from .format import (          # noqa: F401
    SCHEMA,
    ArrivalLog,
    SlotBatch,
    ensure_valid,
    iter_slot_batches,
    load,
    read_jsonl,
    read_npz,
    stream_slot_batches,
    validate_log,
    write_jsonl,
    write_npz,
)
from .synth import production_day, synth_trace  # noqa: F401
from .compile import (         # noqa: F401
    TracePlacement,
    TraceTraffic,
    arrival_rows,
    catalog_plan,
    fit_size_sigma,
    scenario_from_trace,
)

from ..scenarios.spec import SCENARIOS, register

if "production_day" not in SCENARIOS:
    # the source stays the cached thunk, so realize() resynthesizes nothing;
    # lowering itself synthesizes once here to fit the size law
    register(scenario_from_trace(production_day, name="production_day",
                                 seed=11))


def __getattr__(name):
    # replay imports the simulator (repro_torch.core); loading it here would
    # cycle through scenarios/__init__'s tail import of this package
    if name in ("ReplayEngine", "ReplayResult"):
        from . import replay
        return getattr(replay, name)
    raise AttributeError(name)
