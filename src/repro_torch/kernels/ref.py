"""Naive PyTorch oracles for the port's kernels.

Deliberately naive (they materialize the full score matrix or step the
recurrence token by token): they define
*correctness*, as the JAX package's ``kernels/ref.py`` does there, and the
tests hold them against those.  ``ops`` holds the tiled plain versions the
model runs on the CPU, and the CUDA kernels run on the card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["mha_ref", "decode_attention_ref", "wkv6_ref", "rglru_ref"]


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


def wkv6_ref(r, k, v, w, u, state=None):
    """RWKV6 WKV recurrence, token by token (exact oracle).

    r/k/v/w: (B, T, H, D); u: (H, D); state: (B, H, D, D).
      o_t = r_t · (S_{t-1} + diag(u) k_tᵀ v_t)
      S_t = diag(w_t) S_{t-1} + k_tᵀ v_t
    Returns (out (B, T, H, D) fp32, final state fp32).
    """
    B, T, H, D = r.shape
    if state is None:
        state = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    S = state.float()
    r, k, v, w = (x.float() for x in (r, k, v, w))
    u = u.float()
    outs = []
    for t in range(T):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]               # (B, H, D, D)
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


def rglru_ref(x, a_log, state=None):
    """Diagonal gated linear recurrence (RG-LRU core), token by token (exact
    oracle).

    x: (B, T, W) pre-gated inputs; a_log: (B, T, W) log recurrence gates ≤ 0;
    state: (B, W) or None (zeros).
      h_t = exp(a_log_t) · h_{t-1} + sqrt(max(1 − exp(2·a_log_t), 1e-12)) · x_t
    Returns (h (B, T, W) in x's dtype, final state (B, W) fp32).
    """
    B, T, W = x.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=x.device) if state is None
         else state.float())
    x32, al = x.float(), a_log.float()
    hs = []
    for t in range(T):
        a = torch.exp(al[:, t])
        e2 = torch.exp(2.0 * al[:, t].double()).float()       # correctly rounded, as
        gated = torch.sqrt(torch.clamp_min(1.0 - e2, 1e-12)) * x32[:, t]   # rglru_plain
        h = a * h + gated
        hs.append(h)
    return torch.stack(hs, dim=1).to(x.dtype), h
