"""Kernel dispatch layer of the port: the tensor's device picks the path.

Models call these entry points only.  A CPU tensor takes the kernel's plain
PyTorch version; a CUDA tensor launches the hand-written CUDA kernel, whose
wrapper raises on what it cannot take.  Nothing here catches an error and
falls back: on the card the kernels run or the call fails.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import decode_attention as _decode
from repro_torch.kernels import flash_attention as _flash
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import rglru_scan as _rglru
from repro_torch.kernels import rwkv6_scan as _wkv6

__all__ = ["flash_attention", "decode_attention", "paged_attention", "span_attention",
           "paged_span_attention", "wkv6", "rglru_scan"]


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_block: int = 512, kv_block: int = 1024, causal_skip: bool = True):
    """q: (B, S, H, D); k/v: (B, S, Hk, D) -> (B, S, H, D).

    The tile sizes and ``causal_skip`` shape the plain version only; the
    kernel picks its own tiles and always skips hidden KV tiles.  With grad
    enabled and an input that requires it, the call goes through
    ``FlashAttention`` (forward and backward kernels on the card); otherwise,
    as on every serving path, no autograd node is built.
    """
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return _flash.FlashAttention.apply(q, k, v, causal, window, q_block, kv_block,
                                           causal_skip)
    if q.device.type == "cpu":
        return _flash.flash_attention_plain(q, k, v, causal=causal, window=window,
                                            q_block=q_block, kv_block=kv_block,
                                            causal_skip=causal_skip)
    return _flash.flash_attention_cuda(q, k, v, causal=causal, window=window)


def decode_attention(q, k, v, lengths):
    """q: (B, 1, H, D); k/v: (B, Smax, Hk, D), possibly a strided slice of a
    longer cache; lengths: (B,) int32 valid KV lengths -> (B, 1, H, D)."""
    if q.device.type == "cpu":
        return _decode.decode_attention_plain(q, k, v, lengths)
    return _decode.decode_attention_cuda(q, k, v, lengths)


def paged_attention(q, k_pool, v_pool, table, lengths):
    """q: (B, 1, H, D); k_pool/v_pool: (P, page, Hk, D); table: (B, n_pages)
    int32 physical page indices (entries >= P are unmapped sentinels);
    lengths: (B,) int32 valid KV lengths -> (B, 1, H, D)."""
    if q.device.type == "cpu":
        return _paged.paged_attention_plain(q, k_pool, v_pool, table, lengths)
    return _paged.paged_attention_cuda(q, k_pool, v_pool, table, lengths)


def span_attention(q, k, v, base_len):
    """S new query tokens against a contiguous cache (speculative
    verification).  q: (B, S, H, D); k/v: (B, Smax, Hk, D) holding the
    span's own K/V already; base_len: (B,) int32 valid length before the
    span.  Query position i attends ``base_len + i + 1`` keys.

    One :func:`decode_attention` call per position, as the JAX package loops
    its one-token decode (``ops.span_attention``), so every position is the
    one-token decode computation: on the card one kernel launch each.  Each
    query slice is made contiguous, as the kernels take it.  The port's
    ``Model.decode_span`` runs whole decode steps instead; ``chip_smoke.py``'s
    one-pass span probe comes here."""
    return torch.cat([decode_attention(q[:, i:i + 1].contiguous(), k, v, base_len + (i + 1))
                      for i in range(q.shape[1])], dim=1)


def paged_span_attention(q, k_pool, v_pool, table, base_len):
    """The paged form of :func:`span_attention`: q: (B, S, H, D); pools
    (P, page, Hk, D); table: (B, n_pages) int32; base_len: (B,) int32.  One
    :func:`paged_attention` call per position.  Sentinel pages are masked,
    as the kernels mask them; the JAX package's ``paged_span_attention``
    clips them to page P−1 (the port's one deliberate divergence, which
    shows only on retired rows)."""
    return torch.cat([paged_attention(q[:, i:i + 1].contiguous(), k_pool, v_pool, table,
                                      base_len + (i + 1)) for i in range(q.shape[1])], dim=1)


def wkv6(r, k, v, w, u, state=None):
    """RWKV6 recurrence.  r/k/v: (B, T, H, D); w: (B, T, H, D) float32
    decays; u: (H, D); state: (B, H, D, D) float32 or None.  Returns
    ``(out in r's dtype, final state float32)``."""
    if r.device.type == "cpu":
        return _wkv6.wkv6_plain(r, k, v, w, u, state)
    return _wkv6.wkv6_cuda(r, k, v, w, u, state)


def rglru_scan(x, a_log, state=None):
    """RG-LRU recurrence.  x: (B, T, W) in the model dtype; a_log: (B, T, W)
    float32 log-gates ≤ 0; state: (B, W) float32 or None.  Returns ``(h in
    x's dtype, final state float32)``."""
    if x.device.type == "cpu":
        return _rglru.rglru_plain(x, a_log, state)
    return _rglru.rglru_cuda(x, a_log, state)
