"""Attention block of the port: GQA with RoPE and optional QKV bias, the
full-sequence (prefill) path and the paged single-token decode path.

Counterpart of the JAX package's ``models/attention.py`` (``attention_full``
and the paged branch of ``attention_decode``).  Prefill attention goes through
``ops.flash_attention`` and decode through ``ops.paged_attention``; on the card
both are the hand-written CUDA kernels.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig, ShardingConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Dense, apply_rope


class Attention(nn.Module):
    """q/k/v/o projections; q, k and v carry a bias when ``cfg.qkv_bias``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        if cfg.qk_norm:
            raise NotImplementedError("qk_norm is not ported yet")
        d, hd = cfg.d_model, cfg.head_dim
        H, Hk = cfg.n_heads, cfg.n_kv_heads
        self.q = Dense(d, H * hd, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.k = Dense(d, Hk * hd, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.v = Dense(d, Hk * hd, bias=cfg.qkv_bias, dtype=dtype, device=device)
        self.o = Dense(H * hd, d, bias=False, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for lin in (self.q, self.k, self.v, self.o):
            lin.init(generator)


def _heads(x, n: int, hd: int):
    return x.reshape(*x.shape[:-1], n, hd)


def attention_full(p: Attention, cfg: ModelConfig, x, rope, *,
                   shard: ShardingConfig = ShardingConfig()):
    """Causal full-sequence attention.  x: (B, S, d); rope: the RoPE tables
    of positions (B, S) (``layers.rope_tables``), or None.  Returns
    (out, (k, v)) — the rotated K/V so prefill can fill the cache."""
    B, S, _ = x.shape
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = apply_rope(_heads(p.q(x), H, hd), rope)
    k = apply_rope(_heads(p.k(x), Hk, hd), rope)
    v = _heads(p.v(x), Hk, hd)
    out = ops.flash_attention(q, k, v, causal=True,
                              q_block=shard.attn_q_block, kv_block=shard.attn_kv_block,
                              causal_skip=shard.causal_skip)
    return p.o(out.reshape(B, S, H * hd)), (k, v)


def attention_decode(p: Attention, cfg: ModelConfig, x, k_pool, v_pool, pos, table, rope):
    """One-token decode against a paged KV cache.

    x: (B, 1, d); k_pool/v_pool: this layer's ``(P + 1, page_size, Hk, hd)``
    pools, whose last page is the drop page; pos: (B,) int32 current
    positions; table: (B, n_cols) int32 physical pages (entries >= P are
    unmapped); rope: the RoPE tables of ``pos`` (``layers.rope_tables``), or
    None.  The new K/V is written into the pools in place — JAX donates
    the cache to the decode jit and updates it in place; here the pools are
    simply mutated.  A write whose page is unmapped (a retired slot's table is
    all sentinels, or ``pos`` ran past the table) would be dropped by JAX's
    ``mode="drop"`` scatter; here it is routed to the drop page, which no
    table maps and no read sees.  Returns the attention output (B, 1, d).
    """
    B = x.shape[0]
    H, Hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    P, ps = k_pool.shape[0] - 1, k_pool.shape[1]
    n_cols = table.shape[1]
    q = apply_rope(_heads(p.q(x), H, hd), rope)
    k_new = apply_rope(_heads(p.k(x), Hk, hd), rope)
    v_new = _heads(p.v(x), Hk, hd)
    pos64 = pos.long()
    page = pos64 // ps
    rows = torch.arange(B, device=x.device)
    phys = torch.where(page < n_cols, table[rows, page.clamp(max=n_cols - 1)].long(), P)
    phys = phys.clamp(max=P)                      # any sentinel lands on the drop page
    k_pool[phys, pos64 % ps] = k_new[:, 0].to(k_pool.dtype)
    v_pool[phys, pos64 % ps] = v_new[:, 0].to(v_pool.dtype)
    out = ops.paged_attention(q, k_pool[:P], v_pool[:P], table, pos + 1)
    return p.o(out.reshape(B, 1, H * hd))
