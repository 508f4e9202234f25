"""Dense decoder-only model of the port: prefill and paged single-token decode.

Counterpart of the dense path of the JAX package's ``models/transformer.py``
(``Model.init``, ``prefill(lengths=)``, ``decode_step(table=)``,
``init_paged_cache``).  Where JAX stacks the layers on a leading axis and
scans over them, the port keeps an ``nn.ModuleList`` of blocks and loops;
the weight bridge (``repro_torch.models.bridge``) unstacks the JAX leaves.

Supported: global-attention decoder stacks with RMSNorm, SwiGLU, RoPE and
optional QKV bias — the configs this slice serves.  Other families raise
``NotImplementedError`` at construction.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from repro_torch.config import ModelConfig, ShardingConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import Attention, attention_decode, attention_full
from repro_torch.models.layers import (
    RMSNorm,
    empty_param,
    init_normal_,
    rope_freqs,
    rope_tables,
)
from repro_torch.models.mlp import MLP

__all__ = ["Model", "Block"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = []
    if cfg.family != "dense" or cfg.moe is not None:
        unsupported.append(f"family {cfg.family!r}")
    if any(k != "attn" for k in cfg.layer_kinds()):
        unsupported.append(f"blocks {sorted(set(cfg.layer_kinds()))}")
    if cfg.norm != "rmsnorm":
        unsupported.append(f"norm {cfg.norm!r}")
    if cfg.enc_dec or cfg.frontend:
        unsupported.append("encoder-decoder / modality frontend")
    if cfg.tie_embeddings:
        unsupported.append("tied embeddings")
    if cfg.rope_type not in ("rope", "none"):
        unsupported.append(f"rope_type {cfg.rope_type!r}")
    if cfg.dtype not in _DTYPES:
        unsupported.append(f"dtype {cfg.dtype!r}")
    if unsupported:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(unsupported)}")


class Block(nn.Module):
    """Pre-norm decoder block: ``x + attn(n1(x))``, then ``x + mlp(n2(x))``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.n1 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.n2 = RMSNorm(cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.n1, self.attn, self.n2, self.mlp):
            m.init(generator)


class Model(nn.Module):
    """The dense decoder.  Parameters are created uninitialized on ``device``
    (default ``"cuda"``, which raises when no card is present): fill them
    with :meth:`init` or from the JAX package through the weight bridge."""

    def __init__(self, cfg: ModelConfig, shard: Optional[ShardingConfig] = None, *,
                 device="cuda"):
        super().__init__()
        _check_supported(cfg)
        dev = resolve_device(device)
        self.cfg = cfg
        self.shard = shard or ShardingConfig()
        # vocab padded to a 32-multiple as in the JAX package; the padded
        # logits are masked to -1e30
        self.vocab_padded = ((cfg.vocab_size + 31) // 32) * 32
        self.dtype = _DTYPES[cfg.dtype]
        d = cfg.d_model
        self.embed = empty_param((self.vocab_padded, d), self.dtype, dev)
        self.blocks = nn.ModuleList(Block(cfg, dtype=self.dtype, device=dev)
                                    for _ in range(cfg.n_layers))
        self.final_norm = RMSNorm(d, cfg.norm_eps, dtype=self.dtype, device=dev)
        self.lm_head = empty_param((d, self.vocab_padded), self.dtype, dev)
        # RoPE inverse frequencies, built once on the device (not a weight)
        inv_freq = None
        if cfg.rope_type == "rope" and int(cfg.head_dim * cfg.rotary_pct) // 2:
            inv_freq = torch.as_tensor(rope_freqs(cfg.head_dim, cfg.rotary_pct, cfg.rope_theta),
                                       dtype=torch.float32, device=dev)
        self.register_buffer("rope_inv_freq", inv_freq, persistent=False)

    @property
    def device(self) -> torch.device:
        return self.embed.device

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Random weights in the JAX ``Builder``'s scheme: normal leaves with
        std 1/sqrt(fan_in) (fan_in = the second-to-last dim, so the embedding
        table's is the padded vocab, as there), norm scales one, biases
        zero.  Draws on ``generator``'s device.  The numbers differ from
        ``jax.random``'s; tests share weights through the bridge instead."""
        init_normal_(self.embed, generator)
        self.final_norm.init(generator)
        for blk in self.blocks:
            blk.init(generator)
        init_normal_(self.lm_head, generator)
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ---------------- helpers ----------------
    def _embed_in(self, tokens):
        return self.embed[tokens.long()].to(self.dtype)

    def _logits(self, x):
        x = self.final_norm(x)
        logits = (x @ self.lm_head.to(x.dtype)).float()
        if self.vocab_padded != self.cfg.vocab_size:
            logits[..., self.cfg.vocab_size:] = -1e30
        return logits

    def _positions(self, B: int, S: int):
        return torch.arange(S, dtype=torch.int32, device=self.device)[None, :].expand(B, S)

    def _rope(self, positions):
        if self.rope_inv_freq is None:
            return None
        return rope_tables(positions, self.rope_inv_freq)

    # ---------------- prefill ----------------
    @torch.no_grad()
    def prefill(self, tokens, lengths=None):
        """Run the full prompt.  tokens: (B, S) int.  Returns ``(logits,
        rows)``: logits (B, 1, V) float32 at each row's last valid token and
        the prefill cache rows ``{"k", "v"}`` of shape (n_layers, B, S, Hk,
        hd) plus ``"len"`` (B,) int32.

        ``lengths`` (B,): valid prompt lengths of a right-padded batch.
        Causal attention keeps the padding out of the valid prefix; logits
        are gathered at ``lengths - 1`` and ``len`` is set per row.
        """
        x = self._embed_in(tokens)
        B, S = x.shape[:2]
        rope = self._rope(self._positions(B, S))
        ks, vs = [], []
        for blk in self.blocks:
            a, (k, v) = attention_full(blk.attn, self.cfg, blk.n1(x), rope, shard=self.shard)
            x = x + a
            x = x + blk.mlp(blk.n2(x))
            ks.append(k)
            vs.append(v)
        if lengths is not None:
            lengths = lengths.to(device=self.device, dtype=torch.int32)
            last = x[torch.arange(B, device=self.device), lengths.long() - 1][:, None]
        else:
            lengths = torch.full((B,), S, dtype=torch.int32, device=self.device)
            last = x[:, -1:]
        rows = {"k": torch.stack(ks), "v": torch.stack(vs), "len": lengths}
        return self._logits(last), rows

    # ---------------- paged decode ----------------
    def init_paged_cache(self, n_pages: int, page_size: int, batch: int) -> dict:
        """The paged serving cache: per-layer K/V pools stacked as
        ``(n_layers, n_pages + 1, page_size, Hk, hd)`` and the per-slot
        lengths ``len`` (batch,) int32.  Page ``n_pages`` is the drop page:
        the target of writes to unmapped positions, never mapped by a table
        and never read.  (JAX keeps one ``len`` per layer; they are always
        equal, so the port keeps one.)"""
        cfg = self.cfg
        shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
        k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        return {"k": k, "v": torch.zeros_like(k),
                "len": torch.zeros(batch, dtype=torch.int32, device=self.device)}

    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, table):
        """tokens: (B, 1) int; cache from :meth:`init_paged_cache`; table:
        (B, n_cols) int32 block table (entries >= n_pages unmapped), one for
        every layer.  Appends each row's K/V at ``cache["len"]`` and advances
        ``len`` by one, both in place.  Returns logits (B, 1, V) float32."""
        if table is None:
            raise NotImplementedError("the contiguous KV cache is not ported yet; "
                                      "decode_step needs a block table")
        x = self._embed_in(tokens)
        pos = cache["len"]
        rope = self._rope(pos[:, None])
        for i, blk in enumerate(self.blocks):
            x = x + attention_decode(blk.attn, self.cfg, blk.n1(x), cache["k"][i],
                                     cache["v"][i], pos, table, rope)
            x = x + blk.mlp(blk.n2(x))
        cache["len"] += 1
        return self._logits(x)
