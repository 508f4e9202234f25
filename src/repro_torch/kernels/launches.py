"""Launch counters of the kernel wrappers, safe across threads.

Each wrapper counts the kernels it launches in ``<wrapper>.launches``.  The
online server runs different pool members' engines on different threads at
once, so two rules keep the counts those of the work the card did:

* :func:`count` adds under one lock, so no increment is lost to another
  thread's;
* while a thread captures a CUDA graph (:func:`tally`), its launches are
  recorded into the graph, not run: they go to that thread's tally, which
  the graph adds at every replay, and never touch the counters that other
  threads' launches go to meanwhile.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

__all__ = ["count", "tally"]

_lock = threading.Lock()
_local = threading.local()


def count(fn, n: int = 1) -> None:
    """Add ``n`` launches of wrapper ``fn``: to the calling thread's capture
    tally while it captures, else to ``fn.launches``."""
    t = getattr(_local, "tally", None)
    if t is not None:
        t[fn] = t.get(fn, 0) + n
        return
    with _lock:
        fn.launches += n


@contextmanager
def tally():
    """Collect the calling thread's launches in a dict {wrapper: launches}
    instead of the counters, for the length of a capture."""
    prev = getattr(_local, "tally", None)
    _local.tally = t = {}
    try:
        yield t
    finally:
        _local.tally = prev
