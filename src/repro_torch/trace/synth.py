"""Synthesize production-shaped arrival traces (one "production day").

Copy of ``repro.trace.synth`` (numpy): the same seed gives the same trace,
array for array.

The generator layers the ingredients real scheduler telemetry shows:

  diurnal base       sinusoidal intensity over the day
  flash crowds       short multiplicative spikes at random offsets
  placement churn    episode boundaries where the chunk-id -> data mapping
                     is reshuffled upstream (recorded in ``churn_t`` so the
                     compiler re-derives the catalog per epoch)
  Zipf popularity    a small hot set of chunk ids takes most of the tasks
  lognormal sizes    mean-1 per-task service-size multipliers

Timestamps come from inverse-CDF sampling of the integrated intensity on a
fine grid — fully vectorized, deterministic in ``seed``.  ``production_day``
is the canonical parameterization the registry scenario and benchmarks use
(cached per (n_tasks, seed): it is re-realized by every canonical-pad
sweep)."""
from __future__ import annotations

import numpy as np

from .format import ArrivalLog, ensure_valid

_GRID = 4096          # intensity-integration resolution (slots-agnostic)


def synth_trace(*, name: str = "synthetic", n_tasks: int = 50_000,
                horizon: float = 86_400.0, seed: int = 0,
                diurnal_amp: float = 0.3, diurnal_cycles: float = 1.0,
                n_flash: int = 2, flash_peak: float = 3.0,
                flash_frac: float = 0.02, n_chunks: int = 512,
                zipf_s: float = 1.1, churn_t: tuple = (),
                size_sigma: float = 0.35,
                n_tenants: int = 0) -> ArrivalLog:
    """One synthetic trace; see module docstring for the ingredient model.

    flash episodes each last ``flash_frac`` of the horizon at ``flash_peak``
    times the base intensity; ``churn_t`` boundaries reshuffle which chunk
    ids are hot (an independent popularity-rank permutation per epoch).
    Deterministic in ``seed``."""
    if n_tasks <= 0:
        raise ValueError("n_tasks must be > 0")
    rng = np.random.default_rng(seed)

    # -- intensity profile on a fine grid -> inverse-CDF timestamps --------
    x = (np.arange(_GRID) + 0.5) / _GRID
    lam = 1.0 + diurnal_amp * np.sin(2.0 * np.pi * diurnal_cycles * x
                                     - 0.5 * np.pi)
    for _ in range(n_flash):
        f0 = rng.uniform(0.05, 0.95 - flash_frac)
        lam = np.where((x >= f0) & (x < f0 + flash_frac),
                       lam * flash_peak, lam)
    lam = np.maximum(lam, 0.02)
    cdf = np.concatenate([[0.0], np.cumsum(lam)])
    cdf /= cdf[-1]
    u = np.sort(rng.random(n_tasks))
    t = np.interp(u, cdf, np.arange(_GRID + 1) / _GRID) * horizon
    t = np.minimum(t, np.nextafter(horizon, 0.0))

    # -- Zipf chunk popularity, rank->id permuted per churn epoch ----------
    pop = np.arange(1, n_chunks + 1, dtype=np.float64) ** (-zipf_s)
    pop /= pop.sum()
    ranks = rng.choice(n_chunks, size=n_tasks, p=pop)
    bounds = np.asarray((0.0, *churn_t, 1.0)) * horizon
    epoch = np.clip(np.searchsorted(bounds, t, side="right") - 1,
                    0, len(churn_t))
    chunk = np.empty(n_tasks, np.int64)
    for e in range(len(churn_t) + 1):
        perm = rng.permutation(n_chunks)
        m = epoch == e
        chunk[m] = perm[ranks[m]]

    # -- mean-1 lognormal sizes, optional tenants --------------------------
    z = rng.standard_normal(n_tasks)
    size = np.exp(size_sigma * z - 0.5 * size_sigma ** 2).astype(np.float32)
    tenant = None
    if n_tenants > 0:
        tp = np.arange(1, n_tenants + 1, dtype=np.float64) ** -1.0
        tenant = rng.choice(n_tenants, size=n_tasks,
                            p=tp / tp.sum()).astype(np.int32)

    return ensure_valid(ArrivalLog(
        name=name, horizon=float(horizon), t=t, chunk=chunk, size=size,
        tenant=tenant, churn_t=tuple(float(c) for c in churn_t)))


# -- the canonical production day -------------------------------------------

PRODUCTION_DAY_SEED = 7
_PRODUCTION_CACHE: dict = {}


def production_day(n_tasks: int = 120_000,
                   seed: int = PRODUCTION_DAY_SEED) -> ArrivalLog:
    """The canonical "production day": diurnal base, two flash crowds, two
    placement-churn episodes, Zipf(1.1) popularity over 512 chunks,
    lognormal(0.35) sizes, 8 tenants.  Cached per (n_tasks, seed) — the
    registry scenario realizes it on every canonical-pad sweep."""
    key = (int(n_tasks), int(seed))
    if key not in _PRODUCTION_CACHE:
        _PRODUCTION_CACHE[key] = synth_trace(
            name="production_day", n_tasks=n_tasks, seed=seed,
            diurnal_amp=0.3, diurnal_cycles=1.0,
            n_flash=2, flash_peak=3.0, flash_frac=0.02,
            n_chunks=512, zipf_s=1.1, churn_t=(0.45, 0.8),
            size_sigma=0.35, n_tenants=8)
    return _PRODUCTION_CACHE[key]


def main(argv=None) -> None:
    """CLI: synthesize a production-day trace and write it to disk.

    python -m repro_torch.trace.synth --out day.jsonl [--n-tasks N] [--seed S]
    The encoding follows the extension (.jsonl or .npz)."""
    import argparse

    from .format import write_jsonl, write_npz

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--out", required=True,
                    help="output path (.jsonl or .npz)")
    ap.add_argument("--n-tasks", type=int, default=5_000)
    ap.add_argument("--seed", type=int, default=PRODUCTION_DAY_SEED)
    args = ap.parse_args(argv)
    log = production_day(n_tasks=args.n_tasks, seed=args.seed)
    if args.out.endswith(".npz"):
        write_npz(log, args.out)
    elif args.out.endswith(".jsonl"):
        write_jsonl(log, args.out)
    else:
        raise SystemExit(f"--out must end in .jsonl or .npz: {args.out}")
    print(f"[synth] wrote {log.n_tasks}-task production-day trace "
          f"({log.n_epochs} placement epochs) -> {args.out}")


if __name__ == "__main__":
    main()
