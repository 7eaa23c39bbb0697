"""Deterministic, shard-aware synthetic token pipeline (a copy of
``repro/data/synthetic.py``: pure numpy, so the batches are the JAX
package's exactly).

Real deployments plug a tokenized corpus in here; the interface is the part
the framework depends on:

  * deterministic by (seed, step, shard) -> restart/elastic-safe: after a
    preemption the stream resumes exactly, even on a different host count;
  * per-host sharding by `(process_index, process_count)` so each host
    materializes only its slice of the global batch;
  * background prefetch with a bounded queue (straggler smoothing).

Token stream: a mixture of Zipf-distributed unigrams with short Markov
back-references, which gives a non-trivial learnable distribution (loss
drops well below uniform) without external data.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLMDataset:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    shard_index: int = 0
    shard_count: int = 1
    zipf_a: float = 1.2

    def __post_init__(self):
        assert self.global_batch % self.shard_count == 0
        self.local_batch = self.global_batch // self.shard_count
        # fixed unigram table (deterministic across hosts)
        rng = np.random.default_rng(self.seed)
        ranks = np.arange(1, self.vocab + 1, dtype=np.float64)
        p = ranks ** (-self.zipf_a)
        self._p = p / p.sum()
        self._perm = rng.permutation(self.vocab)

    def batch(self, step: int) -> np.ndarray:
        """[local_batch, seq_len+1] int32 tokens for `step` (deterministic)."""
        out = np.empty((self.local_batch, self.seq_len + 1), np.int32)
        for i in range(self.local_batch):
            row = self.shard_index * self.local_batch + i
            rng = np.random.default_rng(
                (self.seed, step, row)
            )
            toks = self._perm[
                rng.choice(self.vocab, size=self.seq_len + 1, p=self._p)
            ].astype(np.int32)
            # Markov back-references: 25% of positions copy t-δ (learnable)
            back = rng.random(self.seq_len + 1) < 0.25
            delta = rng.integers(1, 8, size=self.seq_len + 1)
            for t in np.nonzero(back)[0]:
                if t - delta[t] >= 0:
                    toks[t] = toks[t - delta[t]]
            out[i] = toks
        return out


def make_batch_iterator(
    ds: SyntheticLMDataset,
    start_step: int = 0,
    prefetch: int = 2,
) -> Iterator[np.ndarray]:
    """Background-prefetching iterator starting at `start_step` (resumable)."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def producer():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    th = threading.Thread(target=producer, daemon=True)
    th.start()

    class _Iter:
        def __iter__(self):
            return self

        def __next__(self):
            return q.get()

        def close(self):
            stop.set()

    return _Iter()
