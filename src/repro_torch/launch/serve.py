"""Serving launcher (PyTorch mirror of ``repro.launch.serve``): a replica
fleet + ``PodRouter`` + real decode, on ``--device`` (the card by
default).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch llama3_8b --smoke \
        --requests 32 --replicas 8 --pods 2 --policy pod [--device cpu]
"""
from __future__ import annotations

import argparse

import numpy as np

from ..configs import get
from ..models import init_params
from ..sched import FleetTopology, PodRouter, service_rates
from ..serve import Request, ServeEngine


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--replicas", type=int, default=8)
    ap.add_argument("--pods", type=int, default=2)
    ap.add_argument("--policy", default="pod", choices=("pod", "full"))
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get(args.arch, smoke=args.smoke)
    params = init_params(cfg, 0, device=args.device)
    fleet = FleetTopology(n_replicas=args.replicas, n_pods=args.pods)
    router = PodRouter(fleet, service_rates(), policy=args.policy, device=args.device)
    rng = np.random.default_rng(0)
    prefix_homes = {i: rng.choice(args.replicas, size=3, replace=False)
                    for i in range(8)}
    eng = ServeEngine(cfg, params, fleet, router, prefix_homes)
    reqs = [Request(rid=i, prefix_id=int(rng.integers(0, 8)),
                    prompt=rng.integers(0, cfg.vocab, size=4),
                    max_new=args.max_new, arrival=0)
            for i in range(args.requests)]
    eng.submit(reqs)
    stats = eng.run(until_done=len(reqs))
    comp = np.array(stats.completions)
    print(f"[serve] {len(comp)} requests done; mean completion "
          f"{comp.mean():.1f} ticks (p95 {np.percentile(comp, 95):.0f}); "
          f"locality {stats.locality.round(3).tolist()}; "
          f"probes/decision {stats.probes_per_decision:.1f} "
          f"({args.policy})")
    return stats


if __name__ == "__main__":
    main()
