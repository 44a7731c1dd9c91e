"""Synthetic token pipeline, a copy of the reference package's
(``repro/data/pipeline.py``), numpy only: the same seed gives the same
batches bit for bit.

The stream synthesizes language-like tokens with Zipfian unigram
statistics and local repetition (so the loss goes down in the training
runs).  It is deterministic in (seed, host_id) and yields fixed-shape
batches; with several hosts each draws a disjoint shard of the global
batch.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    num_hosts: int = 1
    host_id: int = 0
    seed: int = 0
    zipf_a: float = 1.2            # unigram skew
    repeat_p: float = 0.3          # prob. of copying a recent token
    repeat_window: int = 32

    @property
    def host_batch(self) -> int:
        if self.global_batch % self.num_hosts:
            raise ValueError("global batch must divide hosts")
        return self.global_batch // self.num_hosts


class TokenStream:
    """Deterministic synthetic token batches: {"tokens", "labels"}."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self.rng = np.random.default_rng(
            np.random.SeedSequence([cfg.seed, cfg.host_id]))
        # Zipf unigram distribution over the vocab (ids 4.. reserved 0-3)
        ranks = np.arange(1, cfg.vocab_size - 4 + 1, dtype=np.float64)
        p = 1.0 / np.power(ranks, cfg.zipf_a)
        self._p = p / p.sum()
        self._ids = np.arange(4, cfg.vocab_size)

    def _sample_seq(self, n: int) -> np.ndarray:
        cfg = self.cfg
        base = self.rng.choice(self._ids, size=n, p=self._p)
        out = base.copy()
        # local repetition: with prob repeat_p copy a token from the window
        coin = self.rng.random(n) < cfg.repeat_p
        offs = self.rng.integers(1, cfg.repeat_window + 1, size=n)
        for i in range(1, n):
            if coin[i]:
                j = max(0, i - int(offs[i]))
                out[i] = out[j]
        return out.astype(np.int32)

    def batch(self) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B, S = cfg.host_batch, cfg.seq_len
        toks = np.stack([self._sample_seq(S + 1) for _ in range(B)])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        while True:
            yield self.batch()


def eval_stream(cfg: DataConfig, num_batches: int = 4):
    """Fixed eval batches (separate seed stream)."""
    ev = TokenStream(dataclasses.replace(cfg, seed=cfg.seed + 10_000))
    return [ev.batch() for _ in range(num_batches)]
