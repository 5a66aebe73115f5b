"""Deterministic synthetic data pipeline (port of ``repro.data.pipeline``,
numpy only, batch for batch the reference's: the same numpy streams, the
same ``seek``).

Two generators:
  * :class:`MarkovLM` — token stream from a fixed random Markov chain, so
    a language model has real structure to learn (loss decreases); used by
    the end-to-end training example and integration tests.
  * :class:`SyntheticVision` — deterministic image-like classification
    batches for the CNN accuracy reproduction (paper Table 3), since no
    external datasets exist in this offline container.

Both are host-shardable: ``shard(host_id, n_hosts)`` partitions the stream
deterministically, and :class:`Prefetcher` overlaps host generation with
device compute (double-buffer), the standard input-pipeline overlap trick.
"""

from __future__ import annotations

import queue
import threading

import numpy as np


class MarkovLM:
    """Order-1 Markov chain over ``vocab`` tokens with temperature-skewed
    rows; entropy well below uniform so CE has headroom to drop."""

    def __init__(self, vocab: int, batch: int, seq: int, seed: int = 0,
                 host_id: int = 0, n_hosts: int = 1):
        self.vocab, self.batch, self.seq = vocab, batch, seq
        rng = np.random.default_rng(seed)
        logits = rng.normal(size=(vocab, vocab)) * 2.0
        self.probs = np.exp(logits - logits.max(-1, keepdims=True))
        self.probs /= self.probs.sum(-1, keepdims=True)
        self.host_id, self.n_hosts = host_id, n_hosts
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self):
        # deterministic per (step, host): restartable after preemption
        rng = np.random.default_rng(
            (self._step * self.n_hosts + self.host_id) * 2654435761 % 2**32
        )
        self._step += 1
        b = self.batch
        toks = np.empty((b, self.seq + 1), np.int32)
        toks[:, 0] = rng.integers(0, self.vocab, size=b)
        u = rng.random((b, self.seq))
        cum = np.cumsum(self.probs, axis=-1)
        for t in range(self.seq):
            toks[:, t + 1] = np.argmax(u[:, t : t + 1] < cum[toks[:, t]], axis=-1)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def seek(self, step: int):
        self._step = step


class SyntheticVision:
    """K-class problem: class k = fixed random template + noise."""

    def __init__(self, n_classes: int, shape, batch: int, seed: int = 0,
                 noise: float = 0.7):
        rng = np.random.default_rng(seed)
        self.templates = rng.normal(size=(n_classes,) + tuple(shape)).astype(np.float32)
        self.n_classes, self.batch, self.noise = n_classes, batch, noise
        self._step = 0

    def __iter__(self):
        return self

    def __next__(self):
        rng = np.random.default_rng(self._step)
        self._step += 1
        y = rng.integers(0, self.n_classes, size=self.batch)
        x = self.templates[y] + rng.normal(
            size=(self.batch,) + self.templates.shape[1:]
        ).astype(np.float32) * self.noise
        return {"x": x.astype(np.float32), "y": y.astype(np.int32)}


class Prefetcher:
    """Background-thread double buffering of a host iterator.  ``close()``
    stops the thread (the reference's runs until its iterator ends)."""

    def __init__(self, it, depth: int = 2):
        self._q = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                pass
        return False

    def _run(self):
        try:
            for item in self._it:
                if not self._put(item):
                    return
        finally:
            self._put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._done:
            raise StopIteration
        return item

    def close(self, timeout: float = 5.0):
        """Stop the producer thread and wait for it."""
        self._stop.set()
        self._thread.join(timeout)
