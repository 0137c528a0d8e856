"""Named host spans at the layer boundaries of the simulator.

``span(name)`` records the host range of its ``with`` block into the
``torch.profiler`` session that is recording, as a CPU operation of that
name: the profiler times it on the clock of the device's kernels, so a
trace puts each idle gap of the card beside the layer the host was in.
Tracing is on exactly when a profiler records; otherwise a span site costs
one check and hands back a shared null context (no string is formatted,
nothing is allocated).

A span is not mirrored onto the device's timeline: it is recorded at
FUNCTION scope (``_RecordFunctionFast``), where ``record_function``'s
USER_SCOPE range gets a copy among the device's operations.

``SPANS`` lists every name the simulator records, grouped by layer:

  grid entry point   sim.grid.realize, sim.grid.cells, sim.grid.summarize
                     (once a call: the fixed cost around the slot loop)
  draws              sim.draws (a slot's view of its draw block, the
                     block's fill in its first slot's, where the whole
                     loop steps eagerly; a block's fill where the step
                     replays as CUDA graphs), inside it
                     sim.draws.fill (one cell's block), sim.draws.stack
                     (a block of every cell), sim.draws.class_grid (full
                     BP's locality classes)
  slot step          (eager slots only: a slot that a CUDA graph replays,
                     on the homogeneous path or off it, records none)
                     sim.scenario.speed (a slot's speeds, off the
                     homogeneous path), sim.step.service,
                     sim.step.schedule, sim.step.accumulate,
                     sim.step.telemetry (the collectors)
  routing            (eager slots only) sim.step.route (the arrival
                     batch and its routing),
                     inside it kernels.route_commit (the kernel's wrapper:
                     checks, outputs and launch)
"""
from __future__ import annotations

import contextlib

import torch
from torch._C._profiler import _RecordFunctionFast as _Range

SPANS = (
    "sim.grid.realize", "sim.grid.cells", "sim.grid.summarize",
    "sim.draws", "sim.draws.fill", "sim.draws.stack", "sim.draws.class_grid",
    "sim.scenario.speed", "sim.step.service", "sim.step.schedule",
    "sim.step.route", "kernels.route_commit", "sim.step.accumulate",
    "sim.step.telemetry",
)

_recording = torch._C._autograd._profiler_enabled
_OFF = contextlib.nullcontext()


def span(name: str):
    """Context manager: the host range ``name`` (one of ``SPANS``) in the
    profiler that records, or a null context when none does."""
    return _Range(name) if _recording() else _OFF
