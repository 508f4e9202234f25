"""Naive PyTorch oracles for the port's attention kernels.

Deliberately naive (they materialize the full score matrix): they define
*correctness*, as the JAX package's ``kernels/ref.py`` does there, and the
tests hold them against those.  ``ops`` holds the tiled plain versions the
model runs on the CPU, and the CUDA kernels run on the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["mha_ref", "decode_attention_ref"]


def _expand_kv(x, groups: int):
    """(B, S, Hk, D) -> (B, S, Hk*groups, D) by repeating each KV head."""
    return x.repeat_interleave(groups, dim=2)


def mha_ref(q, k, v, *, causal: bool = True, window: int | None = None):
    """Naive attention. q: (B, Sq, H, D); k/v: (B, Skv, Hk, D); GQA via repeat.

    ``window``: sliding-window size (keys within [pos-window+1, pos]).
    """
    B, Sq, H, D = q.shape
    Hk = k.shape[2]
    k = _expand_kv(k, H // Hk).float()
    v = _expand_kv(v, H // Hk).float()
    Skv = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(D)
    q_pos = torch.arange(Sq, device=q.device)[:, None] + (Skv - Sq)   # align ends
    k_pos = torch.arange(Skv, device=q.device)[None, :]
    mask = torch.ones((Sq, Skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window is not None:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask[None, None], scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)


def decode_attention_ref(q, k, v, lengths):
    """Single-token decode. q: (B, 1, H, D); k/v: (B, Smax, Hk, D);
    lengths: (B,) valid KV lengths."""
    B, _, H, D = q.shape
    Hk = k.shape[2]
    k = _expand_kv(k, H // Hk).float()
    v = _expand_kv(v, H // Hk).float()
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k) / math.sqrt(D)
    valid = (torch.arange(k.shape[1], device=q.device)[None, :]
             < lengths[:, None])[:, None, None, :]
    scores = torch.where(valid, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs, v).to(q.dtype)
