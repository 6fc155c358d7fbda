"""Deterministic synthetic LM data pipeline.

A copy of ``repro/data/pipeline.py`` (numpy only, as there): the same
(seed, step, host) give bit-identical batches.  It produces a learnable
token stream (order-2 mixture process: each token depends on the previous
token plus a slowly varying "topic"), packed into fixed-length sequences
with EOS boundaries; every host generates only its shard of the global
batch.  Stub-frontend extras (patch/frame embeddings) are keyed off the
same stream.  The reference's ``make_batch_specs`` builds jax dry-run
specs and is left out.
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    n_hosts: int = 1
    host_id: int = 0
    eos: int = 1
    extras: dict = dataclasses.field(default_factory=dict)
    # extras: name -> (shape_fn(batch, seq), np_dtype)

    def __post_init__(self):
        assert self.global_batch % self.n_hosts == 0
        self.host_batch = self.global_batch // self.n_hosts
        # fixed mixing tables make the stream learnable (not iid noise)
        rng = np.random.default_rng(self.seed)
        self._shift = rng.integers(1, self.vocab - 1)
        self._topic_period = 97

    def _sequence(self, step: int, row: int) -> np.ndarray:
        """One packed sequence: documents of random length, EOS-separated."""
        gidx = step * self.global_batch + self.host_id * self.host_batch + row
        rng = np.random.default_rng((self.seed, gidx))
        out = np.empty(self.seq_len + 1, np.int32)
        pos = 0
        while pos < self.seq_len + 1:
            doc_len = int(rng.integers(16, max(17, self.seq_len // 2)))
            tok = int(rng.integers(2, self.vocab))
            topic = int(rng.integers(2, self.vocab))
            n = min(doc_len, self.seq_len + 1 - pos)
            for i in range(n):
                out[pos + i] = tok
                nxt = (tok * 3 + topic + (i % self._topic_period)) % self.vocab
                noise = int(rng.integers(0, 4))
                tok = nxt if noise else int(rng.integers(2, self.vocab))
            pos += n
            if pos < self.seq_len + 1:
                out[pos] = self.eos
                pos += 1
        return out[: self.seq_len + 1]

    def batch(self, step: int) -> dict:
        seqs = np.stack([self._sequence(step, r)
                         for r in range(self.host_batch)])
        tokens = seqs[:, :-1]
        targets = seqs[:, 1:]
        weights = (targets != self.eos).astype(np.float32)
        out = {"tokens": tokens, "targets": targets, "weights": weights}
        rng = np.random.default_rng((self.seed, step, self.host_id, 7))
        for name, (shape_fn, dtype) in self.extras.items():
            shp = shape_fn(self.host_batch, self.seq_len)
            out[name] = rng.standard_normal(shp).astype(np.float32)
        return out

    def __iter__(self):
        step = 0
        while True:
            yield self.batch(step)
            step += 1


__all__ = ["SyntheticLM"]
