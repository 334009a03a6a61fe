"""Deterministic, resumable, sharded token pipeline (a copy of
``repro/data/pipeline.py``, which is plain numpy: every batch is the
reference's, bit for bit).

Design for 1000+ hosts: a batch is a PURE FUNCTION of (seed, step, host)
— there is no queue to drain, no iterator state to snapshot, no straggler
coupling: a restarted or replaced host reproduces exactly its shard of any
step. Resumption = "set step". This is the strongest form of data-pipeline
fault tolerance and it costs nothing for synthetic / pre-tokenized data.

Two sources:
  * ``SyntheticLM``  — Zipf-ish token stream (framework runs and dry runs)
  * ``CorpusLM``     — pre-tokenized memory-mapped corpus with strided
                       deterministic addressing (examples use a generated
                       corpus file; swap the mmap for production data)
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Iterator, Optional, Tuple

import numpy as np


def _rng_for(seed: int, step: int, host: int) -> np.random.Generator:
    key = hashlib.sha256(f"{seed}|{step}|{host}".encode()).digest()[:8]
    return np.random.default_rng(int.from_bytes(key, "little"))


@dataclasses.dataclass(frozen=True)
class PipelineSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    n_hosts: int = 1
    host_id: int = 0
    seed: int = 0

    @property
    def host_batch_size(self) -> int:
        assert self.global_batch % self.n_hosts == 0
        return self.global_batch // self.n_hosts


class SyntheticLM:
    """Zipf tokens with a next-token structure (so loss can decrease)."""

    def __init__(self, spec: PipelineSpec):
        self.spec = spec

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        s = self.spec
        rng = _rng_for(s.seed, step, s.host_id)
        b = s.host_batch_size
        base = rng.zipf(1.3, size=(b, s.seq_len + 1)).astype(np.int64)
        tokens = (base % (s.vocab_size - 2)) + 1
        # inject learnable bigram structure: x_{t+1} = f(x_t) half the time
        follow = (tokens * 31 + 7) % (s.vocab_size - 2) + 1
        mask = rng.random((b, s.seq_len + 1)) < 0.5
        tokens = np.where(mask, np.roll(follow, 1, axis=1), tokens)
        return {"tokens": tokens[:, :-1].astype(np.int32),
                "labels": tokens[:, 1:].astype(np.int32)}


class CorpusLM:
    """Strided reader over a flat pre-tokenized array (mmap-able)."""

    def __init__(self, spec: PipelineSpec, corpus: np.ndarray):
        self.spec = spec
        self.corpus = corpus

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        s = self.spec
        b = s.host_batch_size
        n = len(self.corpus) - s.seq_len - 1
        rng = _rng_for(s.seed, step, s.host_id)
        starts = rng.integers(0, n, size=b)
        toks = np.stack([self.corpus[st:st + s.seq_len + 1]
                         for st in starts])
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}


@dataclasses.dataclass
class PipelineState:
    """What a checkpoint needs to resume the pipeline exactly."""
    step: int
    seed: int

    def to_dict(self):
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d):
        return cls(**d)
