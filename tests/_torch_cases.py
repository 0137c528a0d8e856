"""Inputs shared by the port's CPU parity tests and its card tests."""
import numpy as np


def valid_patterns(B: int, lam: float, rng) -> dict:
    """The ``valid`` patterns the route_commit kernels branch on (their
    chain runs to the last valid arrival, the rest score against the final
    W): none valid, only the last, only the first, a Poisson(lam) prefix as
    the simulator draws it, and gaps before the last valid arrival."""
    gaps = rng.random(B) < 0.5
    last = B - 1 - B // 4
    gaps[last], gaps[last + 1:] = True, False
    return {"none": np.zeros(B, bool), "last": np.arange(B) == B - 1,
            "first": np.arange(B) == 0,
            "poisson": np.arange(B) < min(B, rng.poisson(lam)), "gaps": gaps}
