"""Scratch that the chained kernels hold across calls.

A chained kernel (the RG-LRU forward's and backward's chains, the WKV6
backward's reverse chain) hands each chunk's carry to the next block
through flags, tagged words and a ticket counter, and every launch leaves
them zero for the next one, so they are allocated once and never cleared.
Two launches in flight at once must not share them: one grid's last ticket
would reset the counter under the other, and a block would wait for a
predecessor that never publishes.  So each (owner, device, stream) holds
its own buffer: launches on one stream run one after the other, and
launches on two streams never meet in one buffer.
"""
from __future__ import annotations

import torch

__all__ = ["held_zeros"]

_held: dict[tuple[str, torch.device, int], torch.Tensor] = {}


def held_zeros(owner: str, device, stream: int, n: int, dtype) -> torch.Tensor:
    """``owner``'s scratch for its launches on ``stream`` of ``device``
    (``stream`` a CUDA stream's ``cuda_stream`` handle; any int on the
    CPU): at least ``n`` elements of ``dtype``, zero before the first launch
    and left zero by every launch of the owner's kernels, so it is allocated
    once (and again only to grow) and held across calls.  A CUDA graph
    bakes its address in, so growing it while the stream is captured
    raises: run the shape once eagerly on that stream first."""
    device = torch.device(device)
    key = (owner, device, stream)
    buf = _held.get(key)
    if buf is None or buf.numel() < n:
        if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{owner} on {device} must grow to {n} words while stream "
                               f"{stream:#x} is captured; run this shape once eagerly on "
                               f"that stream before capturing it")
        buf = torch.zeros(n, dtype=dtype, device=device)
        _held[key] = buf
    return buf
