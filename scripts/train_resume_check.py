"""Check that the port's ``Trainer`` resumes bit for bit, and run the
shard-balancing phase of ``examples/train_checkpoint_restart.py`` with the
port's ``ShardBalancer``.

    CUBLAS_WORKSPACE_CONFIG=:4096:8 python3 scripts/train_resume_check.py DIR
    python3 scripts/train_resume_check.py DIR --device cpu     # a rehearsal

llama3-8b at smoke width trains 20 steps straight, then again with a
failure injected at step 13 (async saves) and a fresh ``Trainer`` that
auto-resumes from the step-12 checkpoint: the resumed losses must equal
the straight run's steps 12-19 bit for bit.  On the card that needs
``torch.use_deterministic_algorithms(True)`` (set here) and
``CUBLAS_WORKSPACE_CONFIG`` in the environment before the process starts
cuBLAS.  Then the port restores the final checkpoint that it wrote and
every leaf is byte-compared with the trainer's state.  Last, 16 workers in
4 pods, worker 5 at a quarter speed from step 50: the straggler must get
fewer than half the healthy workers' mean of 200 shards, at O(1) probes a
decision.  Prints one JSON line; exits 1 when a check fails.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))


def _bytes(t: torch.Tensor) -> bytes:
    t = t.detach().cpu().contiguous()
    return (t.view(torch.int16) if t.dtype == torch.bfloat16 else t).numpy().tobytes()


def resume_check(directory: str, device: str) -> dict:
    """Straight, crashed and resumed Trainers on ``device`` with their
    checkpoints under ``directory``; returns what the checks read."""
    from repro_torch import pytree
    from repro_torch.checkpoint import checkpoint as ckpt
    from repro_torch.configs import get
    from repro_torch.data import PipelineConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import Trainer, TrainerConfig

    cfg = get("llama3_8b", smoke=True)
    ocfg = AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=100)

    def trainer(sub: str, **kw) -> Trainer:
        pipe = SyntheticLM(PipelineConfig(vocab=cfg.vocab, seq_len=64, global_batch=8))
        tcfg = TrainerConfig(total_steps=20, ckpt_every=6, log_every=100,
                             ckpt_dir=os.path.join(directory, sub), **kw)
        return Trainer(cfg, ocfg, tcfg, pipe, log_fn=lambda s: None, device=device)

    t0 = time.perf_counter()
    straight = trainer("straight", async_ckpt=False).run()
    crashed = trainer("resumed", async_ckpt=True, fail_at_step=13)
    try:
        crashed.run()
        raise AssertionError("the injected failure did not fire")
    except RuntimeError as e:
        if "injected failure" not in str(e):
            raise
    resumed = trainer("resumed", async_ckpt=False)
    out = resumed.run()
    (state, pipe_state), manifest = ckpt.restore(
        os.path.join(directory, "resumed"), 20, (resumed.state, {"step": 0, "seed": 0}))
    paths, mine, _ = pytree.flatten_with_paths(resumed.state)
    same = [p for p, a, b in zip(paths, mine, pytree.leaves(state))
            if a.dtype == b.dtype and a.device == b.device and _bytes(a) == _bytes(b)]
    losses = np.array(straight["losses"])
    return {"device": str(mine[0].device), "start_step": resumed.start_step,
            "resumed_losses_equal": bool(np.array_equal(losses[12:], np.array(out["losses"]))),
            "first_loss": float(losses[0]), "last_loss": float(losses[-1]),
            "leaves": len(paths), "leaves_byte_equal": len(same),
            "pipeline_step": int(pipe_state["step"]), "codec": manifest["codec"],
            "step_ms_median": float(np.median(straight["step_times"][3:]) * 1e3),
            "seconds": time.perf_counter() - t0}


def shard_balance() -> dict:
    """Phase 3 of examples/train_checkpoint_restart.py, on the port."""
    from repro_torch.sched import ShardBalancer

    bal = ShardBalancer(n_workers=16, n_pods=4)
    rng = np.random.default_rng(0)
    for step in range(200):           # worker 5 degrades to 25% speed after step 50
        for w in range(16):
            bal.observe(w, step_time=4.0 if (w == 5 and step > 50) else 1.0, expected=1.0)
        bal.assign(rng.choice(16, size=3, replace=False))
        bal.drain(0.3)
    counts = np.zeros(16, int)
    for _ in range(200):
        counts[bal.assign(rng.choice(16, size=3, replace=False))] += 1
        bal.drain(0.3)
    return {"shards": counts.tolist(), "straggler": int(counts[5]),
            "healthy_mean": float(np.delete(counts, 5).mean()),
            "probes_per_decision": bal.probes / bal.decisions}


def main() -> int:
    """Run both checks, print their JSON line; 0 when every check holds."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("directory", help="an empty directory for the checkpoints")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    if args.device != "cpu":
        torch.use_deterministic_algorithms(True)
    res = {"resume": resume_check(args.directory, args.device), "balance": shard_balance()}
    r, b = res["resume"], res["balance"]
    res["ok"] = bool(r["start_step"] == 12 and r["resumed_losses_equal"]
                     and r["leaves_byte_equal"] == r["leaves"] and r["pipeline_step"] == 20
                     and r["last_loss"] < r["first_loss"]
                     and b["straggler"] < b["healthy_mean"] / 2
                     and b["probes_per_decision"] <= 11)
    print(json.dumps(res))
    return 0 if res["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
