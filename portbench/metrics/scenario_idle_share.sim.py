"""scenario_idle_share.sim: the device's idle time inside the program's
``sim.scenario.speed`` spans (a slot's speeds, their expansion to the cells
and the cells' inverse rates) over the traced window (share); None where no
such span fires."""
from portbench.metrics._spans import idle_share

SPEED = ("sim.scenario.speed",)


def read(trace):
    return idle_share(trace, SPEED)
