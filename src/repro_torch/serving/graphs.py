"""CUDA graphs of the port's fused decode programs.

The JAX package compiles each fused decode dispatch into one program: the
engine's ``decode_block`` steps are one jitted ``lax.scan``, and the host
dispatches it once per K tokens.  The port's counterpart is one
``torch.cuda.CUDAGraph`` replay per K tokens.  A graph replays the launches
its body made while it was captured, so it runs the same hand-written
kernels and the same PyTorch operators as the eager body, with none of
their host time.

:class:`GraphSet` keeps one graph per key, as JAX keeps one jit variant per
value of its static arguments: the engine keys on (horizon bucket,
``sample``) for the contiguous layout and (table column count, ``sample``)
for the paged one, and :class:`RecurrentDecoder` on the batch.  All graphs
of a set share one memory pool.  A body reads its inputs from static
buffers that the caller fills before each call, and returns tensors that
the next replay of its key overwrites.

The first call with a new key runs the body eagerly, as real work: capture
does not run the kernels, and that first call also builds them, warms
cuBLAS and allocates the kernels' held scratch, which must exist before a
capture.  Later calls capture once and then replay.  On the CPU, where
CUDA graphs do not exist, every call runs the body eagerly on the same
static buffers.  On the card nothing falls back: a capture or a replay that
fails raises.

The kernel wrappers count their launches in Python, which a replay does not
run; the set collects each wrapper's launches at capture in the capturing
thread's tally (capture launched nothing), and adds them at every replay,
so the counts stay those of the work the card did
(:mod:`repro_torch.kernels.launches`).

Captures may run on several threads at once: the online server runs each
pool member's engine on its own worker thread, and a member's engine may
capture while another's launches or synchronises.  So each set captures on
a stream of its own, in CUDA's thread-local capture mode (another thread's
allocations and synchronisations neither fail nor invalidate the capture),
and without the device-wide synchronisation that ``torch.cuda.graph`` makes
on entry, which would touch the other thread's capturing stream.  PyTorch
hands streams out from a pool of 32 a device, so two sets may draw the
same one; one lock keeps captures apart (they are rare: once a key), while
replays and eager calls run unlocked.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Callable, Hashable

import torch

from repro_torch.kernels import launches as launch_counts

__all__ = ["GraphSet", "StaticInput", "RecurrentDecoder"]

_capture_lock = threading.Lock()     # held by a capture, capture_begin to capture_end


class GraphSet:
    """Keyed CUDA graphs of bodies over static buffers, on one device.

    ``run(key, body)``: on the card, the first call with ``key`` runs
    ``body()``; the second captures it into a graph and replays that; every
    later call replays.  On the CPU it runs ``body()``.  Returns what the
    body returned (for a graph, the tensors it returned at capture, which
    each replay rewrites).  ``graphs`` maps each key to its graph;
    ``n_replays`` counts replays.  On the card ``stream`` is the set's own
    capture stream.
    """

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.on_card = self.device.type == "cuda"
        self.pool = torch.cuda.graph_pool_handle() if self.on_card else None
        self.stream = torch.cuda.Stream(self.device) if self.on_card else None
        self.graphs: dict[Hashable, Captured] = {}
        self._warm: set = set()
        self.n_replays = 0

    def run(self, key: Hashable, body: Callable):
        if not self.on_card:
            return body()
        entry = self.graphs.get(key)
        if entry is None:
            if key not in self._warm:
                self._warm.add(key)
                return body()
            entry = self.graphs[key] = self._capture(body)
        entry.graph.replay()
        for fn, n in entry.launches:
            launch_counts.count(fn, n)
        self.n_replays += 1
        return entry.out

    def _capture(self, body: Callable) -> "Captured":
        """Capture ``body`` into a graph of this set's pool, with its outputs
        and each wrapper's launches in it."""
        with launch_counts.tally() as tally:
            graph, out = self._record(body)
        return Captured(graph, out, list(tally.items()))

    def _record(self, body: Callable):
        """The CUDA capture itself: runs the body's Python once on the set's
        capture stream, which records its launches without running them.
        The capture stream first waits for the work queued on the current
        stream, and the current stream (where replays run) for the capture."""
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.device(self.device), _capture_lock:
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    out = body()
                finally:
                    graph.capture_end()
            current.wait_stream(self.stream)
        return graph, out


@dataclass
class Captured:
    """One captured body: its graph, the outputs each replay rewrites, and
    (wrapper, launches) for every kernel wrapper it launched."""
    graph: object
    out: object
    launches: list


class StaticInput:
    """A device tensor that a graph reads (``tensor``), refilled from the
    host by ``load(values)``: on the card one non-blocking copy from a pinned
    mirror.  The caller reads each dispatch's outputs (a synchronisation)
    before the next ``load``, so the mirror is never rewritten under a copy
    still in flight."""

    def __init__(self, shape, dtype, device):
        self.tensor = torch.zeros(shape, dtype=dtype, device=device)
        self._host = torch.zeros(shape, dtype=dtype, pin_memory=self.tensor.is_cuda)

    def load(self, values) -> None:
        self._host.numpy()[...] = values
        self.tensor.copy_(self._host, non_blocking=True)


class RecurrentDecoder:
    """Greedy decoding of a recurrent or hybrid model (RWKV6, RG-LRU
    hybrids), ``decode_block`` steps a call: on the card one graph replay
    over a static cache, on the CPU the same steps eagerly.

    The counterpart of the engine's fused dispatch for the stacks the engine
    does not serve (the JAX engine serves attention stacks only, so it has
    no sampled recurrent path, and neither has this).  ``start(cache,
    tokens)`` copies a cache of :meth:`Model.prefill` (or of
    ``init_cache``) and the next input tokens (B,) into the static buffers
    of batch B, allocated at first use; each ``__call__`` then runs K greedy
    ``decode_step``s on them and returns the (K, B) int32 tokens, a tensor
    the next call of the same batch rewrites.  ``cache(B)`` is the static
    cache of batch B.  Graphs are keyed on the batch.
    """

    def __init__(self, model, decode_block: int = 8):
        self.model = model
        if decode_block < 1:
            raise ValueError(f"RecurrentDecoder: decode_block must be >= 1, got {decode_block}")
        self.decode_block = int(decode_block)
        self.graphs = GraphSet(model.device)
        self._static: dict[int, tuple[dict, torch.Tensor]] = {}
        self._batch = None

    def start(self, cache: dict, tokens: torch.Tensor) -> None:
        B = int(tokens.shape[0])
        if B not in self._static:
            self._static[B] = ({k: torch.empty_like(v) for k, v in cache.items()},
                               torch.empty((B, 1), dtype=torch.int32, device=tokens.device))
        static, last = self._static[B]
        if set(static) != set(cache) or any(static[k].shape != v.shape for k, v in cache.items()):
            raise ValueError("RecurrentDecoder.start: the cache's leaves differ from the ones "
                             "this batch was first started with")
        for k, v in cache.items():
            static[k].copy_(v)
        last.copy_(tokens.reshape(B, 1))
        self._batch = B

    def cache(self, batch: int) -> dict:
        return self._static[batch][0]

    def __call__(self) -> torch.Tensor:
        if self._batch is None:
            raise RuntimeError("RecurrentDecoder: call start() first")
        B = self._batch
        return self.graphs.run(B, lambda: self._body(B))

    def _body(self, B: int) -> torch.Tensor:
        """K greedy steps on batch B's static cache and tokens; the last
        token is written back into the static input for the next call."""
        cache, last = self._static[B]
        toks = []
        tok = last
        for _ in range(self.decode_block):
            logits = self.model.decode_step(tok, cache)
            tok = logits[:, 0].argmax(dim=-1).to(torch.int32)[:, None]
            toks.append(tok[:, 0])
        last.copy_(tok)
        return torch.stack(toks)
