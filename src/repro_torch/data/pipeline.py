"""Deterministic data pipeline — the numpy part of
``repro.data.pipeline`` (``DataConfig``, ``TokenDataset``), copied so
that the port needs nothing of the JAX package.

Every (step, example-index) pair maps to content by a counter-based
PRNG (one Philox stream each), so a restart at step k regenerates
exactly the batches the failed run would have seen, and the JAX package
and the port train on the same batches bit for bit.  ``ImageDataset``
and ``device_batch`` wait for the CNN serving slice.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0


def _counter_rng(seed: int, step: int, index: int) -> np.random.Generator:
    # counter-based: one Philox stream per (seed, step, index)
    return np.random.Generator(np.random.Philox(key=seed,
                                                counter=[0, 0, step, index]))


class TokenDataset:
    """Synthetic LM corpus: per-example Markov-ish token streams (enough
    structure that loss decreases during training)."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg

    def example(self, step: int, index: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        rng = _counter_rng(cfg.seed, step, index)
        # mixture of a narrow and a broad distribution -> learnable bigrams
        base = rng.integers(0, cfg.vocab_size, size=cfg.seq_len + 1)
        walk = np.cumsum(rng.integers(0, 17, size=cfg.seq_len + 1)) % \
            cfg.vocab_size
        use_walk = rng.random(cfg.seq_len + 1) < 0.7
        toks = np.where(use_walk, walk, base).astype(np.int32)
        return {"tokens": toks[:-1], "labels": toks[1:]}

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        exs = [self.example(step, i) for i in range(cfg.global_batch)]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}

    def host_batch(self, step: int, host_id: int,
                   n_hosts: int) -> Dict[str, np.ndarray]:
        """The shard one host materializes: a contiguous slice of the
        global index space."""
        cfg = self.cfg
        if cfg.global_batch % n_hosts:
            raise ValueError(f"global batch {cfg.global_batch} does not "
                             f"split over {n_hosts} hosts")
        per = cfg.global_batch // n_hosts
        lo = host_id * per
        exs = [self.example(step, lo + i) for i in range(per)]
        return {k: np.stack([e[k] for e in exs]) for k in exs[0]}
