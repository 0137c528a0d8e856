"""grid_fixed_ms.sim: the grid entry point's fixed cost of the traced call,
the summed duration of the program's ``sim.grid.realize``,
``sim.grid.cells`` and ``sim.grid.summarize`` spans (ms): the work around
the slot loop that every ``simulate_grid`` call repeats."""
from portbench.metrics._spans import GRID, span_ms


def read(trace):
    return span_ms(trace, GRID)
