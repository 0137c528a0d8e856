"""Telemetry: windowed metrics, distribution collectors and probe-quality
instrumentation (PyTorch mirror of ``repro.telemetry``).

The collectors are tensors carried through the simulator's slot loop, one
row a grid cell, updated in place on the run's device: they take no random
draw (a run with telemetry is bit-identical to one without) and read no
tensor on the host (``collectors``).

Three layers, as in the reference:

  windowed time series   the run's T slots split into ``n_windows`` equal
                         windows; per window, SUM channels (WINDOW_SUMS)
                         and MAX channels (WINDOW_MAXES);
  distributions          per-window log-spaced histograms of per-server
                         queue length and workload, and a whole-run
                         per-task sojourn histogram fed by FIFO rings of
                         arrival slots (``hist`` holds the bin convention:
                         the reference's float32 bins, exactly);
  probe quality          per pod decision, the rank of the chosen server's
                         score among all M and the regret against the O(M)
                         optimum (BP-Pod against JSQ-MaxWeight-Pod: the
                         paper's d-sensitivity claim, observed directly).

``export`` is the reference's host-side numpy code (JSONL events, windowed
drift, sojourn percentiles, the auto-extend warmup), with ``to_numpy``
taking the port's tensors to the host and a grid's flat cell axis to the
reference's [seeds, loads] / [scenarios, seeds, loads] layout.

Entry points: ``core.simulate_with_telemetry``,
``core.simulate_grid_with_telemetry``, ``core.simulate_auto_warmup`` and
``core.simulate_sweep(..., telemetry=...)``.
"""
from .collectors import (
    WINDOW_MAXES,
    WINDOW_SUMS,
    Telemetry,
    TelemetryConfig,
    ZERO_PROBE,
    collect_step,
    probe_stats_max,
    probe_stats_min,
    record_sojourns,
    ring_pop,
    ring_push,
    zero_telemetry,
)
from .export import (
    SCHEMA_VERSION,
    WarmupPolicy,
    WarmupReport,
    aggregate,
    auto_extend_warmup,
    cell_view,
    format_clip_warning,
    probe_summary,
    read_jsonl,
    run_manifest,
    sojourn_percentiles,
    tail_stats,
    to_events,
    to_numpy,
    validate_events,
    window_records,
    windowed_drift,
    write_jsonl,
)
from .hist import (
    BINS_PER_OCTAVE,
    N_BINS,
    bin_edges,
    bin_index,
    np_hist,
    percentiles,
)

__all__ = [n for n in dir() if not n.startswith("_")]
