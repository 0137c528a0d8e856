"""Core library: the Balanced-Pandas family and its slotted simulator."""
from .cluster import (
    GEOMETRIC,
    LOCAL,
    LOGNORMAL,
    RACK,
    REMOTE,
    Cluster,
    Rates,
    capacity_arrival_rate,
    inv_rate_matrix,
    locality_class,
    rate_matrix,
    safe_inv_rates,
    sample_durations,
    sample_locals,
)
from .policies import (
    PodSpec,
    bp_candidates_per_route,
    inv_rate_for,
    jsqmw_candidates_per_schedule,
    lex_argmax,
    lex_argmin,
    masked_draws,
    pod_candidates,
    route_balanced_pandas_full,
    route_pod_candidates,
    weighted_score,
)
from .simulator import (
    ALGORITHMS,
    BP_POD_DEFAULT,
    BPState,
    RawSums,
    SimConfig,
    SimResult,
    SlotDraws,
    TorchDraws,
    resolve_device,
    simulate,
    summarize,
)

__all__ = [n for n in dir() if not n.startswith("_")]
