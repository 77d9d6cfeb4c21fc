"""Deterministic data pipeline — the port of ``repro.data.pipeline``:
``DataConfig``, ``TokenDataset`` and ``ImageDataset`` copied (numpy),
and ``device_batch``, which takes a torch device where the JAX package
takes a sharding.

Every (step, example-index) pair maps to content by a counter-based
PRNG (one Philox stream each), so a restart at step k regenerates
exactly the batches the failed run would have seen, and the JAX package
and the port train on the same batches bit for bit.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Tuple

import numpy as np
import torch


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


class ImageDataset:
    """Synthetic int8 image/label pairs for the CNN examples."""

    def __init__(self, shape: Tuple[int, int, int] = (224, 224, 3),
                 num_classes: int = 1000, seed: int = 0):
        self.shape = shape
        self.num_classes = num_classes
        self.seed = seed

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        rng = _counter_rng(self.seed, step, 0)
        imgs = rng.integers(-127, 128, size=(batch_size,) + self.shape,
                            dtype=np.int8)
        labels = rng.integers(0, self.num_classes, size=(batch_size,),
                              dtype=np.int32)
        return {"images": imgs, "labels": labels}


def device_batch(host_batch: Dict[str, np.ndarray],
                 device="cuda") -> Dict[str, torch.Tensor]:
    """Put a host batch on ``device``, dtypes kept."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in host_batch.items()}
