"""Attention block of the port: GQA with RoPE or M-RoPE, optional QKV bias
and optional QK-norm, the full-sequence (prefill) path, causal with an
optional sliding window or not causal (an encoder), cross-attention over an
encoder's output, the single-token decode path over a paged, a contiguous
or a ring KV cache, and the cross-attention decode over the stored encoder
K/V.

Counterpart of the JAX package's ``models/attention.py`` (``attention_full``
and the paged, contiguous, ring and cross branches of ``attention_decode``;
its ``attention_span`` is S of these decode steps here, through
``Model.decode_span``).  Prefill attention goes through
``ops.flash_attention``, decode through ``ops.paged_attention`` or
``ops.decode_attention``; on the card all of them are the hand-written CUDA
kernels.  A sliding-window layer keeps a ring
buffer of its last ``S_buf`` keys: keys are RoPE-rotated at write time, so
the order of the ring's slots does not matter.  With ``cfg.qk_norm``
(Qwen3) q and k are RMS-normalised over head_dim before RoPE, in every path
(JAX's ``_qk_normalize``).  A cross-attention layer (``Attention(cross=
True)``) has no bias, no QK-norm and no RoPE, as JAX's ``init_attention``
and ``attention_full`` treat ``cross``.  The RoPE tables carry M-RoPE's
three position ids where the model gives them (``layers.rope_tables``), so
the attention code is the same for both.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig, ShardingConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Dense, apply_rope, empty_param


class Attention(nn.Module):
    """q/k/v/o projections; q, k and v carry a bias when ``cfg.qkv_bias``;
    with ``cfg.qk_norm`` the RMSNorm scales ``q_norm`` and ``k_norm`` of
    shape (head_dim,), as the JAX tree names them.  ``cross``: a decoder's
    cross-attention over an encoder (no bias, no QK-norm)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, cross: bool = False):
        super().__init__()
        d, hd = cfg.d_model, cfg.head_dim
        H, Hk = cfg.n_heads, cfg.n_kv_heads
        bias, norm = cfg.qkv_bias and not cross, cfg.qk_norm and not cross
        self.eps = cfg.norm_eps
        self.q = Dense(d, H * hd, bias=bias, dtype=dtype, device=device)
        self.k = Dense(d, Hk * hd, bias=bias, dtype=dtype, device=device)
        self.v = Dense(d, Hk * hd, bias=bias, dtype=dtype, device=device)
        self.o = Dense(H * hd, d, bias=False, dtype=dtype, device=device)
        self.q_norm = empty_param((hd,), dtype, device) if norm else None
        self.k_norm = empty_param((hd,), dtype, device) if norm else None

    def init(self, generator: torch.Generator) -> None:
        for lin in (self.q, self.k, self.v, self.o):
            lin.init(generator)
        if self.q_norm is not None:
            self.q_norm.fill_(1.0)
            self.k_norm.fill_(1.0)


def _heads(x, n: int, hd: int):
    return x.reshape(*x.shape[:-1], n, hd)


def _rms(x, scale, eps: float):
    x32 = x.float()
    var = x32.square().mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * scale.float()).to(x.dtype)


def _qk_normalize(p: Attention, q, k):
    """QK-norm (JAX's ``_qk_normalize``): q and k RMS-normalised over
    head_dim in fp32 with their scales, cast back; unchanged without
    ``qk_norm``."""
    if p.q_norm is None:
        return q, k
    return _rms(q, p.q_norm, p.eps), _rms(k, p.k_norm, p.eps)


def attention_full(p: Attention, cfg: ModelConfig, x, rope, *, causal: bool = True,
                   window=None, kv_source=None, shard: ShardingConfig = ShardingConfig()):
    """Full-sequence attention.  x: (B, S, d); rope: the RoPE tables of the
    positions (``layers.rope_tables``), or None; ``causal``: query i sees
    keys up to i (an encoder passes False: every key); ``window``: query i
    sees keys (i − window, i], or all earlier keys when None.

    ``kv_source`` (B, S_enc, d): cross-attention, keys and values projected
    from the encoder's output; not causal, no QK-norm, no RoPE (``rope`` is
    not read).  Returns (out, (k, v)) — the rotated K/V (the cross K/V) so
    prefill can fill the cache."""
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    cross = kv_source is not None
    src = kv_source if cross else x
    q, k = _heads(p.q(x), H, hd), _heads(p.k(src), Hk, hd)
    v = _heads(p.v(src), Hk, hd)
    if not cross:
        q, k = _qk_normalize(p, q, k)
        q, k = apply_rope(q, rope), apply_rope(k, rope)
    out = ops.flash_attention(q, k, v, causal=causal and not cross, window=window,
                              q_block=shard.attn_q_block, kv_block=shard.attn_kv_block,
                              causal_skip=shard.causal_skip)
    return p.o(out.reshape(B, S, H * hd)), (k, v)


def attention_cross_decode(p: Attention, cfg: ModelConfig, x, k_enc, v_enc, enc_len):
    """One-token cross-attention over the encoder K/V a prefill stored.
    x: (B, 1, d); k_enc/v_enc: this layer's (B, S_enc, Hk, hd); enc_len:
    (B,) int32 valid encoder frames.  Nothing is written (JAX's
    ``attention_decode`` with ``kv_source_cache``).  Returns (B, 1, d)."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    out = ops.decode_attention(_heads(p.q(x), H, hd), k_enc, v_enc, enc_len)
    return p.o(out.reshape(B, 1, H * hd))


def attention_decode(p: Attention, cfg: ModelConfig, x, k_cache, v_cache, pos, table, rope,
                     *, window=None):
    """One-token decode against a paged (``table`` given) or a contiguous
    (``table=None``) KV cache.

    x: (B, 1, d); pos: (B,) int32 current positions; rope: the RoPE tables
    of ``pos`` (``layers.rope_tables``), or None.  The new K/V is written
    into the cache in place — JAX donates the cache to the decode jit and
    updates it in place; here the tensors are simply mutated.  Returns the
    attention output (B, 1, d).

    Paged: k_cache/v_cache are this layer's ``(P + 1, page_size, Hk, hd)``
    pools, whose last page is the drop page; table: (B, n_cols) int32
    physical pages (entries >= P are unmapped).  A write whose page is
    unmapped (a retired slot's table is all sentinels, or ``pos`` ran past
    the table) would be dropped by JAX's ``mode="drop"`` scatter; here it is
    routed to the drop page, which no table maps and no read sees.

    Contiguous: k_cache/v_cache are this layer's ``(B, S_buf, Hk, hd)``
    buffers, possibly a horizon slice ``[:, :S_buf]`` of a longer cache (a
    view, so writes land in the cache itself).  Row b writes at ``pos[b]``
    and attends its first ``min(pos[b] + 1, S_buf)`` positions.  A write at
    ``pos >= S_buf`` (a retired slot's garbage stream running past the
    horizon) is dropped by JAX's scatter and would raise in PyTorch; here
    such a row writes back the value its clamped index already holds, which
    leaves the cache as it was.

    Ring (``window`` given, ``table=None``): k_cache/v_cache are this layer's
    ``(B, S_buf, Hk, hd)`` ring, ``S_buf = min(window, max_len)``.  Row b
    writes at slot ``pos[b] % S_buf`` and attends the ``min(pos[b] + 1,
    S_buf)`` filled slots.  The paged branch refuses a window
    (``ValueError``), as the JAX package asserts.
    """
    if window is not None and table is not None:
        raise ValueError("paged KV cache supports global attention only, not a sliding window")
    B = x.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q, k_new = _qk_normalize(p, _heads(p.q(x), H, hd), _heads(p.k(x), Hk, hd))
    q = apply_rope(q, rope)
    k_new = apply_rope(k_new, rope)[:, 0].to(k_cache.dtype)
    v_new = _heads(p.v(x), Hk, hd)[:, 0].to(v_cache.dtype)
    pos64 = pos.long()
    rows = torch.arange(B, device=x.device)
    if table is not None:
        P, ps = k_cache.shape[0] - 1, k_cache.shape[1]
        n_cols = table.shape[1]
        page = pos64 // ps
        phys = torch.where(page < n_cols, table[rows, page.clamp(max=n_cols - 1)].long(), P)
        phys = phys.clamp(max=P)                  # any sentinel lands on the drop page
        k_cache[phys, pos64 % ps] = k_new
        v_cache[phys, pos64 % ps] = v_new
        out = ops.paged_attention(q, k_cache[:P], v_cache[:P], table, pos + 1)
    elif window is not None:
        S_buf = k_cache.shape[1]
        at = pos64 % S_buf
        k_cache[rows, at] = k_new
        v_cache[rows, at] = v_new
        out = ops.decode_attention(q, k_cache, v_cache, torch.clamp(pos + 1, max=S_buf))
    else:
        S_buf = k_cache.shape[1]
        inside = (pos64 < S_buf)[:, None, None]
        at = pos64.clamp(max=S_buf - 1)
        k_cache[rows, at] = torch.where(inside, k_new, k_cache[rows, at])
        v_cache[rows, at] = torch.where(inside, v_new, v_cache[rows, at])
        out = ops.decode_attention(q, k_cache, v_cache, torch.clamp(pos + 1, max=S_buf))
    return p.o(out.reshape(B, 1, H * hd))
