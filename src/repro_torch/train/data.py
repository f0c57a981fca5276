"""Data pipeline: deterministic synthetic streams + memory-mapped binary
token shards, with host-sharded loading for multi-process launches.

Twin of ``repro.train.data``, in numpy alone: its batches equal the
reference's bit for bit (the same generators, seeds and arithmetic).

Synthetic data is structured (Markov-ish token chains), not uniform noise,
so training loss actually decreases and overfit tests are meaningful.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    path: str | None = None        # None -> synthetic
    num_hosts: int = 1
    host_id: int = 0


class SyntheticLM:
    """Deterministic pseudo-corpus: order-1 Markov chain over the vocab.

    The transition structure (each token strongly prefers a small set of
    successors) gives a learnable signal with known optimal loss.
    """

    def __init__(self, cfg: DataConfig, branch: int = 4):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self.succ = rng.integers(0, v, size=(v, branch), dtype=np.int32)
        self.branch = branch

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.num_hosts
        step = start_step
        while True:
            # Seed by (step, host) -> restart-deterministic and host-disjoint.
            rng = np.random.default_rng(
                (cfg.seed, step, cfg.host_id, 0xD1CE))
            toks = np.empty((per_host, cfg.seq_len + 1), np.int32)
            toks[:, 0] = rng.integers(0, cfg.vocab_size, size=per_host)
            choices = rng.integers(0, self.branch,
                                   size=(per_host, cfg.seq_len))
            for t in range(cfg.seq_len):
                toks[:, t + 1] = self.succ[toks[:, t], choices[:, t]]
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                   "step": step}
            step += 1


class BinaryTokens:
    """Flat uint16/uint32 token file, memory-mapped, strided per host.

    Layout-compatible with the common "tokenizer dump" format (one giant
    token array); sequences are contiguous windows, step-strided so that a
    restart at step k reads exactly the same data.
    """

    def __init__(self, cfg: DataConfig, dtype=np.uint16):
        assert cfg.path is not None
        self.cfg = cfg
        size = os.path.getsize(cfg.path)
        self.tokens = np.memmap(cfg.path, dtype=dtype, mode="r",
                                shape=(size // dtype().itemsize,))
        self.n_windows = (len(self.tokens) - 1) // cfg.seq_len

    def batches(self, start_step: int = 0) -> Iterator[dict]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.num_hosts
        step = start_step
        while True:
            rng = np.random.default_rng((cfg.seed, step, 0xBEEF))
            idx = rng.integers(0, self.n_windows,
                               size=cfg.global_batch)
            idx = idx[cfg.host_id * per_host:(cfg.host_id + 1) * per_host]
            toks = np.stack([
                self.tokens[i * cfg.seq_len:i * cfg.seq_len + cfg.seq_len + 1]
                for i in idx]).astype(np.int32)
            yield {"tokens": toks[:, :-1], "labels": toks[:, 1:],
                   "step": step}
            step += 1


def make_pipeline(cfg: DataConfig):
    return BinaryTokens(cfg) if cfg.path else SyntheticLM(cfg)
