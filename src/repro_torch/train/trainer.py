"""Fault-tolerant training loop (PyTorch mirror of ``repro.train.trainer``).

  - runs the port's ``train_step`` with a checkpointable (params, opt,
    data-cursor) triple, on the card unless ``device`` names another;
  - periodic (optionally async) checkpoints; on start, auto-resume from the
    newest valid checkpoint (atomic manifests mean a crash mid-save is
    harmless);
  - deterministic resume: the data pipeline cursor is part of the
    checkpoint, so a resumed run repeats the uninterrupted one's losses
    (bit for bit, where the device's kernels are deterministic);
  - failure injection hook (``fail_at_step``) for the recovery tests;
  - per-step wall times, for the straggler balancer in
    ``repro_torch.sched.straggler``.
"""
from __future__ import annotations

import dataclasses
import functools
import os
import tempfile
import time
from typing import Callable, Optional

import numpy as np

from ..checkpoint import checkpoint as ckpt
from ..data.pipeline import SyntheticLM
from ..optim.adamw import AdamWConfig
from .train_step import init_train_state, train_step


@dataclasses.dataclass
class TrainerConfig:
    total_steps: int = 100
    ckpt_every: int = 25
    ckpt_dir: str = os.path.join(tempfile.gettempdir(), "repro_ckpt")
    log_every: int = 10
    microbatches: int = 1
    grad_compress: bool = False
    seed: int = 0
    fail_at_step: Optional[int] = None     # failure injection (tests)
    async_ckpt: bool = True


class Trainer:
    def __init__(self, cfg, opt_cfg: AdamWConfig, tcfg: TrainerConfig,
                 pipeline: SyntheticLM,
                 log_fn: Callable[[str], None] = print, *, device=None):
        self.cfg, self.opt_cfg, self.tcfg = cfg, opt_cfg, tcfg
        self.pipeline = pipeline
        self.log = log_fn
        self.step_times: list[float] = []

        self._step = functools.partial(
            train_step, cfg=cfg, opt_cfg=opt_cfg,
            microbatches=tcfg.microbatches,
            grad_compress=tcfg.grad_compress)

        self.state = init_train_state(cfg, opt_cfg, tcfg.seed, device=device)
        self.start_step = 0
        self._maybe_resume()

    # -- fault tolerance ----------------------------------------------------

    def _maybe_resume(self):
        latest = ckpt.restore_latest(self.tcfg.ckpt_dir,
                                     (self.state, {"step": 0, "seed": 0}))
        if latest is not None:
            step, (state, pipe_state), manifest = latest
            self.state = state
            self.pipeline.restore({k: int(v) for k, v in pipe_state.items()})
            self.start_step = step
            self.log(f"[trainer] resumed from checkpoint step {step}")

    def _save(self, step: int):
        pipe_state = {k: np.int64(v) for k, v in self.pipeline.state().items()}
        ckpt.save(self.tcfg.ckpt_dir, step, (self.state, pipe_state),
                  extra={"arch": self.cfg.name},
                  async_=self.tcfg.async_ckpt)

    # -- the loop -------------------------------------------------------------

    def run(self) -> dict:
        losses = []
        for step in range(self.start_step, self.tcfg.total_steps):
            if self.tcfg.fail_at_step is not None and step == self.tcfg.fail_at_step:
                ckpt.join_pending()
                raise RuntimeError(f"injected failure at step {step}")
            batch = self.pipeline.next_batch()
            t0 = time.perf_counter()
            self.state, metrics = self._step(self.state, batch)
            loss = float(metrics["loss"])     # waits for the step's device work
            dt = time.perf_counter() - t0
            self.step_times.append(dt)
            losses.append(loss)
            if step % self.tcfg.log_every == 0:
                self.log(f"[trainer] step {step:5d} loss {loss:.4f} "
                         f"gnorm {float(metrics['grad_norm']):.3f} "
                         f"lr {float(metrics['lr']):.2e} {dt*1e3:.0f}ms")
            if (step + 1) % self.tcfg.ckpt_every == 0 or \
                    step + 1 == self.tcfg.total_steps:
                self._save(step + 1)
        ckpt.join_pending()
        return {"losses": losses, "step_times": self.step_times}
