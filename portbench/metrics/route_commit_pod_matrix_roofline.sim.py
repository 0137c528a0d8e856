"""route_commit_pod_matrix_roofline.sim: route_commit_pod's share of its
roofline in a scenario sweep, where each cell routes on its own [M, 3]
inverse rates (%), from the device trace and the frozen bound."""
from portbench.metrics._roofline_matrix import share


def read(trace):
    return share(trace, "route_commit_pod")
