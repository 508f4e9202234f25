"""Training data pipeline of the port: a synthetic language stream and a
prefetch thread that puts batches on the device.

Counterpart of the JAX package's ``data/pipeline.py`` without the mesh:
``synthetic_lm_stream`` is its copy (numpy, the same batches for the same
seed), and :class:`ShardedPipeline` keeps its name and interface while
placing each batch on one device: a background thread copies the host
arrays into pinned memory and issues ``non_blocking`` copies to the card,
``prefetch`` batches ahead of the consumer.
"""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.device import resolve_device

__all__ = ["synthetic_lm_stream", "ShardedPipeline"]


def synthetic_lm_stream(vocab: int, batch: int, seq: int, seed: int = 0,
                        n_states: int = 64) -> Iterator[dict]:
    """Markov-chain synthetic language (learnable structure, not noise)."""
    rng = np.random.default_rng(seed)
    trans = rng.dirichlet(np.full(n_states, 0.1), size=n_states)
    proj = rng.integers(0, vocab, n_states)
    cum = trans.cumsum(1)
    while True:
        states = np.zeros((batch, seq + 1), np.int64)
        states[:, 0] = rng.integers(0, n_states, batch)
        u = rng.random((batch, seq))
        for t in range(seq):
            states[:, t + 1] = (cum[states[:, t]] > u[:, t:t + 1]).argmax(1)
        tokens = proj[states]
        yield {"tokens": tokens[:, :-1].astype(np.int32),
               "labels": tokens[:, 1:].astype(np.int32)}


class ShardedPipeline:
    """Wraps a host batch iterator: device placement + background prefetch.

    ``device`` defaults to the card (pinned host memory, ``non_blocking``
    copies on the copying thread's current stream, the default one, so a
    step that reads a batch is ordered after its copy); ``"cpu"`` turns the
    arrays into tensors only.  Iterate it for the batches; :meth:`close`
    stops the thread and drops what it prefetched.
    """

    def __init__(self, host_iter: Iterator[dict], device="cuda", prefetch: int = 2):
        self._host = host_iter
        self._device = resolve_device(device)
        self._q: queue.Queue = queue.Queue(maxsize=max(prefetch, 1))
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _place(self, batch: dict) -> dict:
        out = {}
        for k, v in batch.items():
            t = torch.from_numpy(np.ascontiguousarray(v))
            if self._device.type == "cuda":
                t = t.pin_memory().to(self._device, non_blocking=True)
            out[k] = t
        return out

    def _put(self, item) -> bool:
        """Queue ``item`` unless the pipeline closes first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    def _worker(self):
        try:
            for batch in self._host:
                if self._stop.is_set() or not self._put(self._place(batch)):
                    return
        finally:
            self._put(None)

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            self._q.put(None)            # every later next() stops too
            raise StopIteration
        return item

    def close(self):
        """Stop the prefetch thread and wait for it."""
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=5.0)
