"""Synthetic LM data pipeline; the port's counterpart of ``repro.data.tokens``.

Deterministic and seekable (batch k is a pure function of (seed, k) — the
fault-tolerance contract): ``SyntheticTokens.batch_at`` draws from the same
numpy generator as the reference and is bit-identical to it. ``batch_iterator``
prefetches batches onto an explicit device from pinned host memory
(``non_blocking`` copies), ``prefetch`` batches ahead.

The synthetic distribution is a Zipfian unigram mixed with short repeated
n-grams so the model has learnable structure.
"""

from __future__ import annotations

import collections
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.core.plan import resolve_device

__all__ = ["SyntheticTokens", "batch_iterator"]


class SyntheticTokens:
    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 0, ngram: int = 4):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.ngram = ngram
        # Zipfian unigram over a smallish working vocab.
        v = min(vocab_size, 4096)
        ranks = np.arange(1, v + 1, dtype=np.float64)
        self._probs = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._work_vocab = v

    def batch_at(self, step: int, *, host_slice: slice | None = None) -> dict:
        """Global batch for ``step`` (or this host's slice of it), numpy."""
        rng = np.random.default_rng(np.random.SeedSequence([self.seed, step]))
        b = self.global_batch
        toks = rng.choice(self._work_vocab, size=(b, self.seq_len),
                          p=self._probs).astype(np.int32)
        # Plant repeated n-grams: predictable structure for the LM to learn.
        n = self.ngram
        motif = rng.integers(0, self._work_vocab, size=(n,), dtype=np.int32)
        starts = rng.integers(0, self.seq_len - n, size=(b, 8))
        for i in range(b):
            for s in starts[i]:
                toks[i, s:s + n] = motif
        if host_slice is not None:
            toks = toks[host_slice]
        return {"tokens": toks}

    def __iter__(self) -> Iterator[dict]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def batch_iterator(ds: SyntheticTokens, start_step: int = 0, device: Any = None,
                   prefetch: int = 2) -> Iterator[dict]:
    """Device-prefetching iterator starting at ``start_step`` (resume).
    ``device=None`` is the card (raises without one)."""
    dev = resolve_device(device)
    pin = dev.type == "cuda"   # pinned host memory exists only beside a card

    def put(s):
        out = {}
        for k, v in ds.batch_at(s).items():
            t = torch.from_numpy(v)
            out[k] = (t.pin_memory() if pin else t).to(dev, non_blocking=True)
        return out

    q: collections.deque = collections.deque()
    step = start_step
    for _ in range(prefetch):
        q.append(put(step))
        step += 1
    while True:
        out = q.popleft()
        q.append(put(step))
        step += 1
        yield out
