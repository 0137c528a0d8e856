"""Deterministic synthetic LM data pipeline with checkpointable state (a
copy of the reference's numpy module, ``repro.data.pipeline``).

Production shape without external deps: the stream is a pure function of
(seed, step, host shard), so (a) every host reads only its shard, (b) the
pipeline cursor is one integer — it checkpoints/restores exactly, and (c) a
resumed run is bitwise-identical to an uninterrupted one (tested).

The token distribution is a mixture of Zipf-like unigrams and a short
Markov chain so tiny models have real structure to fit (train-loss-decreases
tests and the overfit example rely on this).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Iterator yielding {"tokens": [B_host, S], "labels": [B_host, S]}."""

    def __init__(self, cfg: PipelineConfig, step: int = 0):
        if cfg.global_batch % cfg.n_hosts != 0:
            raise ValueError("global_batch must divide across hosts")
        self.cfg = cfg
        self.step = step
        v = cfg.vocab
        # fixed "language": Zipf unigram + deterministic bigram successor
        rng = np.random.default_rng(cfg.seed)
        self._succ = rng.integers(0, v, size=v, dtype=np.int64)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def state(self) -> dict:
        return {"step": self.step, "seed": self.cfg.seed}

    def restore(self, state: dict) -> None:
        assert state["seed"] == self.cfg.seed, "restoring a different stream"
        self.step = int(state["step"])

    def next_batch(self) -> dict:
        cfg = self.cfg
        b_host = cfg.global_batch // cfg.n_hosts
        # per-(step, host) independent stream — reproducible at any cursor
        rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, self.step, cfg.host_id]))
        first = rng.choice(cfg.vocab, size=(b_host, 1), p=self._unigram)
        toks = [first[:, 0]]
        noise = rng.random((b_host, cfg.seq_len))
        fresh = rng.choice(cfg.vocab, size=(b_host, cfg.seq_len),
                           p=self._unigram)
        for t in range(1, cfg.seq_len + 1):
            prev = toks[-1]
            nxt = np.where(noise[:, t - 1] < 0.75, self._succ[prev],
                           fresh[:, t - 1])
            toks.append(nxt)
        seq = np.stack(toks, axis=1).astype(np.int32)   # [B, S+1]
        self.step += 1
        return {"tokens": seq[:, :-1], "labels": seq[:, 1:]}

    def __iter__(self):
        return self

    def __next__(self):
        return self.next_batch()
