"""Training launcher (PyTorch mirror of ``repro.launch.train``): picks an
arch config (full or --smoke), builds the data pipeline, runs the
fault-tolerant Trainer (checkpoints, auto-resume, straggler telemetry) on
``--device`` (the card by default).

    PYTHONPATH=src python -m repro_torch.launch.train --arch llama3_8b --smoke \
        --steps 100 --ckpt-dir /tmp/repro_train [--device cpu]
"""
from __future__ import annotations

import argparse
import os
import tempfile

from ..configs import get
from ..data import PipelineConfig, SyntheticLM
from ..optim import AdamWConfig
from ..train import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced same-family config (CPU-friendly)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compress", action="store_true")
    ap.add_argument("--int8-moments", action="store_true")
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    cfg = get(args.arch, smoke=args.smoke)
    ocfg = AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                       total_steps=args.steps,
                       moment_dtype="int8" if args.int8_moments else "float32")
    pipe = SyntheticLM(PipelineConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.batch))
    tcfg = TrainerConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                         ckpt_dir=args.ckpt_dir,
                         microbatches=args.microbatches,
                         grad_compress=args.grad_compress)
    out = Trainer(cfg, ocfg, tcfg, pipe, device=args.device).run()
    print(f"[train] done: final loss {out['losses'][-1]:.4f}, "
          f"mean step {1e3 * sum(out['step_times']) / len(out['step_times']):.0f} ms")
    return out


if __name__ == "__main__":
    main()
