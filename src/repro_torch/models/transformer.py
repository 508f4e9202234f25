"""Model of the port: prefill, and single-token decode over a paged or
contiguous KV cache, the RWKV6 recurrent state, or the RG-LRU hybrid's mixed
cache (ring K/V and recurrent state); and the encoder-decoder, whose decoder
cross-attends to an encoder's output.

Counterpart of the JAX package's ``models/transformer.py`` for the families
ported so far (``Model.init``, ``forward``, ``loss``, ``prefill``,
``decode_step``, ``decode_span``, ``init_cache``, ``init_paged_cache``).
Where JAX stacks the layers on a leading axis and
scans over them, the port keeps an ``nn.ModuleList`` of blocks and loops;
the weight bridge (``repro_torch.models.bridge``) unstacks the JAX leaves.
Caches keep the JAX layout with the layers stacked on axis 0.

Supported: global-attention dense stacks with RMSNorm or LayerNorm, a gated
(SwiGLU, GeGLU) or ungated (GELU, squared ReLU) MLP, full or partial RoPE
(``rotary_pct``: StableLM-2 rotates a quarter of each head, Nemotron-4 half)
and optional QKV bias and QK-norm; the same stacks with mixture-of-experts
MLPs (family ``moe``: Qwen1.5-MoE, Qwen3-MoE; ``models/moe.py``); RWKV6 stacks
(family ``ssm``) with LayerNorm; and the RG-LRU hybrid (family ``hybrid``,
RecurrentGemma): RG-LRU blocks mixed with sliding-window (or global)
attention blocks, RMSNorm, GeGLU and RoPE; the vision-language trunk
(family ``vlm``, Qwen2-VL): a dense stack with M-RoPE that takes token ids
or precomputed patch-and-text embeddings, its three position ids a token
given to ``forward``; and the encoder-decoder (family ``audio``,
SeamlessM4T): ``n_encoder_layers`` non-causal attention blocks with RoPE
and their own final norm over precomputed frame embeddings, and a decoder
whose blocks add a cross-attention (norm ``nc``, attention ``cross``)
between self-attention and the MLP.  The frontends are stubs in the JAX
package too: ``repro_torch.launch.specs`` makes their embeddings from a
seed.  Other families raise ``NotImplementedError`` at construction.

A mixture-of-experts stack dispatches its tokens with capacity in
``forward`` and ``prefill`` (JAX's ``apply_moe``) and with ``exact=True``
(capacity = the token count, no drops) in every decode step (JAX's
``moe_exact``).  Capacity counts every (token, slot) pair of the call,
padding included, so a prefilled row's logits depend on its batch.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.config import ModelConfig, ShardingConfig
from repro_torch.device import resolve_device
from repro_torch.models.attention import (
    Attention,
    attention_cross_decode,
    attention_decode,
    attention_full,
)
from repro_torch.models.layers import (
    empty_param,
    init_normal_,
    make_norm,
    rope_freqs,
    rope_tables,
)
from repro_torch.models.mlp import MLP
from repro_torch.models.moe import MoE
from repro_torch.models.rglru import RGLRU
from repro_torch.models.rwkv6 import ChannelMix, TimeMix

__all__ = ["Model", "Block", "Encoder", "RWKVBlock", "RGLRUBlock"]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


_FRONTEND = {"dense": None, "moe": None, "vlm": "vision", "audio": "audio"}


def _check_supported(cfg: ModelConfig) -> None:
    unsupported = []
    kinds = set(cfg.layer_kinds())
    if (cfg.family in ("dense", "vlm", "audio") and cfg.moe is None) or (
            cfg.family == "moe" and cfg.moe):
        if kinds != {"attn"}:
            unsupported.append(f"blocks {sorted(kinds)}")
        if cfg.norm not in ("rmsnorm", "layernorm"):
            unsupported.append(f"norm {cfg.norm!r}")
        if cfg.rope_type not in ("rope", "mrope", "none"):
            unsupported.append(f"rope_type {cfg.rope_type!r}")
        if cfg.rope_type == "mrope" and (
                len(cfg.mrope_sections or ()) != 3
                or sum(cfg.mrope_sections) != int(cfg.head_dim * cfg.rotary_pct) // 2):
            unsupported.append(f"mrope_sections {cfg.mrope_sections} not three summing to "
                               f"rot/2 = {int(cfg.head_dim * cfg.rotary_pct) // 2}")
        if cfg.activation not in ("swiglu", "geglu", "gelu", "relu2"):
            unsupported.append(f"activation {cfg.activation!r}")
        if cfg.frontend not in (None, _FRONTEND[cfg.family]):
            unsupported.append(f"frontend {cfg.frontend!r} in family {cfg.family!r}")
        if cfg.enc_dec != (cfg.family == "audio") or (cfg.enc_dec and cfg.n_encoder_layers < 1):
            unsupported.append(f"enc_dec={cfg.enc_dec} with {cfg.n_encoder_layers} encoder "
                               f"layers in family {cfg.family!r}")
    elif cfg.family == "ssm":
        if kinds != {"rwkv"}:
            unsupported.append(f"blocks {sorted(kinds)}")
        if cfg.norm != "layernorm":
            unsupported.append(f"norm {cfg.norm!r}")
        if cfg.rope_type != "none":
            unsupported.append(f"rope_type {cfg.rope_type!r}")
    elif cfg.family == "hybrid" and cfg.moe is None:
        if (not kinds <= {"rglru", "local", "attn"} or "rglru" not in kinds
                or not kinds & {"local", "attn"}):
            unsupported.append(f"blocks {sorted(kinds)}")
        if {"local", "attn"} <= kinds:
            unsupported.append("global and sliding-window attention in one stack")
        if "local" in kinds and not cfg.window:
            unsupported.append("local attention without a window")
        if cfg.norm != "rmsnorm":
            unsupported.append(f"norm {cfg.norm!r}")
        if cfg.activation != "geglu":
            unsupported.append(f"activation {cfg.activation!r}")
        if cfg.rope_type != "rope":
            unsupported.append(f"rope_type {cfg.rope_type!r}")
    else:
        unsupported.append(f"family {cfg.family!r}")
    if cfg.family in ("ssm", "hybrid") and (cfg.enc_dec or cfg.frontend):
        unsupported.append("encoder-decoder / modality frontend on a recurrent stack")
    if cfg.tie_embeddings:
        unsupported.append("tied embeddings")
    if cfg.dtype not in _DTYPES:
        unsupported.append(f"dtype {cfg.dtype!r}")
    if unsupported:
        raise NotImplementedError(f"{cfg.name}: not ported yet: {', '.join(unsupported)}")


class Block(nn.Module):
    """Pre-norm decoder block: ``x + attn(n1(x))``, then (``cross``, an
    encoder-decoder's decoder block) ``x + cross(nc(x), encoder output)``,
    then ``x + mlp(n2(x))``.  ``window`` is the sliding window of a
    ``local`` block, None for global attention.  ``mlp`` is an :class:`MoE`
    when ``cfg.moe`` is set, using the ``moe_dispatch`` of ``shard``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, window=None,
                 shard: Optional[ShardingConfig] = None, cross: bool = False):
        super().__init__()
        self.window = window
        self.n1 = make_norm(cfg.norm, cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.attn = Attention(cfg, dtype=dtype, device=device)
        self.nc = self.cross = None
        if cross:
            self.nc = make_norm(cfg.norm, cfg.d_model, cfg.norm_eps, dtype=dtype,
                                device=device)
            self.cross = Attention(cfg, dtype=dtype, device=device, cross=True)
        self.n2 = make_norm(cfg.norm, cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        if cfg.moe:
            self.mlp = MoE(cfg, dtype=dtype, device=device,
                           dispatch=(shard or ShardingConfig()).moe_dispatch)
        else:
            self.mlp = MLP(cfg, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.n1, self.attn, self.nc, self.cross, self.n2, self.mlp):
            if m is not None:
                m.init(generator)

    def ffn(self, x, exact: bool = False):
        """``mlp(n2(x))`` and its auxiliary loss (None for a dense MLP);
        ``exact``: an MoE dispatches without capacity drops."""
        if isinstance(self.mlp, MoE):
            return self.mlp(self.n2(x), exact=exact)
        return self.mlp(self.n2(x)), None


class RWKVBlock(nn.Module):
    """RWKV6 block: ``x + tm(n1(x))``, then ``x + cm(n2(x))``; each mix carries
    its token-shift state, the time-mix also the WKV state."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.n1 = make_norm(cfg.norm, cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.tm = TimeMix(cfg, dtype=dtype, device=device)
        self.n2 = make_norm(cfg.norm, cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.cm = ChannelMix(cfg, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.n1, self.tm, self.n2, self.cm):
            m.init(generator)

    def forward(self, x, shift_tm=None, shift_cm=None, wkv=None):
        """x: (B, S, d) and this layer's carried states (None at the start
        of a sequence).  Returns (x, (shift_tm, shift_cm, wkv))."""
        h, (shift_tm, wkv) = self.tm(self.n1(x), shift_tm, wkv)
        x = x + h
        h, shift_cm = self.cm(self.n2(x), shift_cm)
        return x + h, (shift_tm, shift_cm, wkv)


class RGLRUBlock(nn.Module):
    """RecurrentGemma recurrent block: ``x + rec(n1(x))``, then
    ``x + mlp(n2(x))``; ``rec`` carries the conv history and the RG-LRU
    state."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        self.n1 = make_norm(cfg.norm, cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.rec = RGLRU(cfg, dtype=dtype, device=device)
        self.n2 = make_norm(cfg.norm, cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)
        self.mlp = MLP(cfg, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for m in (self.n1, self.rec, self.n2, self.mlp):
            m.init(generator)

    def forward(self, x, conv=None, h=None):
        """x: (B, S, d) and this layer's carried states (None at the start of
        a sequence).  Returns (x, (conv, h))."""
        a, (conv, h) = self.rec(self.n1(x), conv, h)
        x = x + a
        return x + self.mlp(self.n2(x)), (conv, h)


def _recurrent_block(blk, x):
    """An RWKV6 or RG-LRU block over the whole sequence from zero state: (x,
    None), the carried states dropped (training's full forward)."""
    return blk(x)[0], None


def _make_block(cfg: ModelConfig, kind: str, *, dtype, device, shard) -> nn.Module:
    if kind == "rwkv":
        return RWKVBlock(cfg, dtype=dtype, device=device)
    if kind == "rglru":
        return RGLRUBlock(cfg, dtype=dtype, device=device)
    return Block(cfg, dtype=dtype, device=device,
                 window=cfg.window if kind == "local" else None, shard=shard,
                 cross=cfg.enc_dec)


class Encoder(nn.Module):
    """An encoder-decoder's encoder (JAX's ``params["encoder"]``):
    ``n_encoder_layers`` attention blocks, run without a causal mask, and
    their final ``norm``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device, shard):
        super().__init__()
        self.blocks = nn.ModuleList(Block(cfg, dtype=dtype, device=device, shard=shard)
                                    for _ in range(cfg.n_encoder_layers))
        self.norm = make_norm(cfg.norm, cfg.d_model, cfg.norm_eps, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for blk in self.blocks:
            blk.init(generator)
        self.norm.init(generator)


class Model(nn.Module):
    """The decoder: dense attention blocks, RWKV6 blocks for family ``ssm``
    (``recurrent``), or RG-LRU and attention blocks for family ``hybrid``
    (``hybrid``); with ``cfg.enc_dec`` also an :class:`Encoder`
    (``encoder``) whose output the decoder blocks cross-attend to.
    Parameters are created uninitialized on ``device`` (default ``"cuda"``,
    which raises when no card is present): fill them with :meth:`init` or
    from the JAX package through the weight bridge.

    Parameters are created with ``requires_grad=False``, so a serving model
    builds no autograd graph; the trainer (``training.train_loop``) turns
    them on with ``requires_grad_()`` for the model it trains."""

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
        self.recurrent = cfg.family == "ssm"
        self.hybrid = cfg.family == "hybrid"
        kinds = cfg.layer_kinds()
        self.blocks = nn.ModuleList(_make_block(cfg, kind, dtype=self.dtype, device=dev,
                                                shard=self.shard) for kind in kinds)
        # a sliding-window stack keeps its K/V in a ring of min(window, max_len)
        self.kv_window = cfg.window if "local" in kinds else None
        # each layer's place in its cache stack: attention layers index the
        # K/V stack, RG-LRU layers the conv/h stack, in layer order
        is_rec = [kind == "rglru" for kind in kinds]
        self.cache_index = [sum(r == is_rec[i] for r in is_rec[:i]) for i in range(len(kinds))]
        self.final_norm = make_norm(cfg.norm, d, cfg.norm_eps, dtype=self.dtype, device=dev)
        self.lm_head = empty_param((d, self.vocab_padded), self.dtype, dev)
        self.encoder = (Encoder(cfg, dtype=self.dtype, device=dev, shard=self.shard)
                        if cfg.enc_dec else None)
        # M-RoPE's (t, h, w) sections of the frequency bands
        self.mrope_sections = tuple(cfg.mrope_sections) if cfg.rope_type == "mrope" else None
        # RoPE inverse frequencies, built once on the device (not a weight)
        inv_freq = None
        if cfg.rope_type in ("rope", "mrope") and int(cfg.head_dim * cfg.rotary_pct) // 2:
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
        zero, and the RWKV6 leaves' own schemes (``rwkv6.TimeMix.init``).
        Draws on ``generator``'s device.  The numbers differ from
        ``jax.random``'s; tests share weights through the bridge instead."""
        init_normal_(self.embed, generator)
        self.final_norm.init(generator)
        for blk in self.blocks:
            blk.init(generator)
        init_normal_(self.lm_head, generator)
        if self.encoder is not None:
            self.encoder.init(generator)
        return self

    def param_count(self) -> int:
        return sum(p.numel() for p in self.parameters())

    # ---------------- helpers ----------------
    def _embed_in(self, inputs):
        """Token ids (B, S) through the embedding, or float embeddings (B, S,
        d) as they are, cast to the model dtype (JAX's ``_embed_in``: the
        vision stub's patch-and-text embeddings)."""
        if inputs.is_floating_point():
            return inputs.to(device=self.device, dtype=self.dtype)
        return self.embed[inputs.long()].to(self.dtype)

    def _logits(self, x):
        x = self.final_norm(x)
        logits = (x @ self.lm_head.to(x.dtype)).float()
        if self.vocab_padded != self.cfg.vocab_size:
            logits[..., self.cfg.vocab_size:] = -1e30
        return logits

    def _positions(self, B: int, S: int):
        return torch.arange(S, dtype=torch.int32, device=self.device)[None, :].expand(B, S)

    def _rope(self, positions):
        """RoPE tables of positions (B, S), or with M-RoPE of (B, 3, S)
        (temporal, height and width ids); M-RoPE's text positions (B, S)
        take plain RoPE's tables, which equal the three-id ones bit for bit."""
        if self.rope_inv_freq is None:
            return None
        if positions.dim() == 3:
            if self.mrope_sections is None:
                raise ValueError(f"{self.cfg.name}: positions {tuple(positions.shape)} of three "
                                 f"ids a token need rope_type 'mrope'")
            return rope_tables(positions, self.rope_inv_freq, self.mrope_sections)
        return rope_tables(positions, self.rope_inv_freq)

    def _run_encoder(self, enc_inputs):
        """The encoder over frame embeddings (B, S_enc, d): non-causal
        attention blocks with RoPE at positions 0 .. S_enc − 1, then its
        norm (JAX's ``_run_encoder``)."""
        if enc_inputs is None:
            raise ValueError(f"{self.cfg.name}: an encoder-decoder needs enc_inputs, the "
                             f"encoder's frame embeddings (B, S_enc, d)")
        x = enc_inputs.to(device=self.device, dtype=self.dtype)
        rope = self._rope(self._positions(*x.shape[:2]))
        for blk in self.encoder.blocks:
            a, _ = attention_full(blk.attn, self.cfg, blk.n1(x), rope, causal=False,
                                  shard=self.shard)
            x = x + a
            x = x + blk.ffn(x)[0]
        return self.encoder.norm(x)

    # ---------------- full-sequence forward (training) ----------------
    def _dense_block(self, blk, x, rope, enc_out=None):
        """One attention block over the full sequence: (x, aux), aux the
        MoE's load-balance loss or None; a decoder block of an
        encoder-decoder cross-attends to ``enc_out`` between the two."""
        a, _ = attention_full(blk.attn, self.cfg, blk.n1(x), rope, window=blk.window,
                              shard=self.shard)
        x = x + a
        if blk.cross is not None:
            c, _ = attention_full(blk.cross, self.cfg, blk.nc(x), None, kv_source=enc_out,
                                  shard=self.shard)
            x = x + c
        h, aux = blk.ffn(x)
        return x + h, aux

    def forward(self, inputs, enc_inputs=None, positions=None):
        """inputs: token ids (B, S) or float embeddings (B, S, d) (the vision
        stub's); enc_inputs: an encoder-decoder's frame embeddings (B, S_enc,
        d); positions: (B, S) int, with M-RoPE (B, 3, S) (temporal, height
        and width ids), or None (0 .. S−1, the same id three times).
        Returns ``(logits (B, S, V) float32, aux)``, aux the auxiliary loss
        summed over the layers (the MoE's load-balance loss, with capacity
        dispatch; 0 for the other families), as JAX's ``Model.forward``.

        RWKV6 and RG-LRU blocks run over the whole sequence from zero
        state (their WKV6 and RG-LRU calls take ``ops``' autograd nodes
        under grad), a hybrid's attention blocks as the dense ones.  With
        ``shard.remat == "block"`` and grad enabled, each block runs under
        ``torch.utils.checkpoint`` (non-reentrant) and is recomputed in the
        backward, as JAX wraps each scan group in ``jax.checkpoint``."""
        x = self._embed_in(inputs)
        B, S = x.shape[:2]
        pos = positions if positions is not None else self._positions(B, S)
        rope = self._rope(pos.to(self.device))
        enc_out = self._run_encoder(enc_inputs) if self.encoder is not None else None
        remat = self.shard.remat == "block" and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=self.device)
        for blk in self.blocks:
            if isinstance(blk, Block):
                fn, args = self._dense_block, (blk, x, rope, enc_out)
            else:
                fn, args = _recurrent_block, (blk, x)
            x, aux = checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)
            if aux is not None:
                aux_total = aux_total + aux
        return self._logits(x), aux_total

    def loss(self, batch: dict):
        """batch: {"tokens" (B, S) or "embeds" (B, S, d), "labels" (B, S),
        optional "enc_embeds" and "positions"}.  Next-token cross-entropy
        (labels already shifted), mean over the labels that are not −100,
        plus ``aux``; float32, as JAX's ``Model.loss``."""
        logits, aux = self.forward(batch.get("tokens", batch.get("embeds")),
                                   enc_inputs=batch.get("enc_embeds"),
                                   positions=batch.get("positions"))
        labels = batch["labels"].to(device=logits.device, dtype=torch.long)
        mask = (labels >= 0).float()
        safe = labels.clamp_min(0)
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, safe[..., None])[..., 0]
        ce = (logz - gold) * mask
        return ce.sum() / mask.sum().clamp_min(1.0) + aux

    # ---------------- caches ----------------
    def init_cache(self, batch: int, max_len: int, enc_len: int = 0) -> dict:
        """The contiguous serving cache, zeroed, layers stacked on axis 0.

        Attention stacks: ``{"k", "v"}`` of shape (n_layers, batch, max_len,
        Hk, hd) and the per-row lengths ``len`` (batch,) int32.  (JAX keeps
        one ``len`` per layer; they are always equal, so the port keeps
        one.)  RWKV6 stacks: the token-shift states ``shift_tm``/``shift_cm``
        (n_layers, batch, d) in the model dtype and the WKV state ``wkv``
        (n_layers, batch, H, hd, hd) in fp32; ``max_len`` does not apply.

        RG-LRU hybrids: one stack per kind, each in layer order —
        ``{"k", "v"}`` (n_attn, batch, S_buf, Hk, hd) for the attention
        layers, a ring of ``S_buf = min(window, max_len)`` slots for local
        attention (``max_len`` for global); ``conv`` (n_rec, batch, cw − 1,
        W) in the model dtype and ``h`` (n_rec, batch, W) fp32 for the
        RG-LRU layers; and one ``len`` (batch,) int32.  Layer i sits at
        position ``cache_index[i]`` of its kind's stack.  The JAX package
        keeps layer ``i = g·P + s`` (P = len(block_pattern), g < n_groups =
        n_layers // P) at ``cache["blocks"][f"b{s}"][leaf][g]`` and layer
        ``i = n_groups·P + j`` at ``cache[f"rem{j}"][leaf]``.

        An encoder-decoder adds its decoder's cross K/V, ``{"cross_k",
        "cross_v"}`` of shape (n_layers, batch, enc_len, Hk, hd), and their
        valid lengths ``cross_len`` (batch,) int32, ``enc_len`` (every frame
        valid).  JAX keeps them at ``cache[...]["cross"]``, with a ``len``
        of zeros in ``init_cache``; over zero K/V either length gives the
        same zero output.
        """
        cfg, dev = self.cfg, self.device
        if self.recurrent:
            d, hd = cfg.d_model, cfg.rwkv_head_dim
            shift = torch.zeros((cfg.n_layers, batch, d), dtype=self.dtype, device=dev)
            return {"shift_tm": shift, "shift_cm": torch.zeros_like(shift),
                    "wkv": torch.zeros((cfg.n_layers, batch, d // hd, hd, hd),
                                       dtype=torch.float32, device=dev)}
        n_rec = sum(isinstance(b, RGLRUBlock) for b in self.blocks)
        n_attn = cfg.n_layers - n_rec
        size = min(max_len, self.kv_window or max_len)
        shape = (n_attn, batch, size, cfg.n_kv_heads, cfg.head_dim)
        k = torch.zeros(shape, dtype=self.dtype, device=dev)
        cache = {"k": k, "v": torch.zeros_like(k),
                 "len": torch.zeros(batch, dtype=torch.int32, device=dev)}
        if self.encoder is not None:
            ck = torch.zeros((cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim),
                             dtype=self.dtype, device=dev)
            cache.update(cross_k=ck, cross_v=torch.zeros_like(ck),
                         cross_len=torch.full((batch,), enc_len, dtype=torch.int32, device=dev))
        if self.hybrid:
            W = cfg.lru_width or cfg.d_model
            cache["conv"] = torch.zeros((n_rec, batch, cfg.conv_width - 1, W),
                                        dtype=self.dtype, device=dev)
            cache["h"] = torch.zeros((n_rec, batch, W), dtype=torch.float32, device=dev)
        return cache

    def init_paged_cache(self, n_pages: int, page_size: int, batch: int) -> dict:
        """The paged serving cache: per-layer K/V pools stacked as
        ``(n_layers, n_pages + 1, page_size, Hk, hd)`` and the per-slot
        lengths ``len`` (batch,) int32.  Page ``n_pages`` is the drop page:
        the target of writes to unmapped positions, never mapped by a table
        and never read.  Decoder-only attention stacks only, as in JAX."""
        if self.recurrent or self.hybrid or self.encoder is not None:
            raise ValueError("paged KV cache requires a decoder-only global-attention stack")
        cfg = self.cfg
        shape = (cfg.n_layers, n_pages + 1, page_size, cfg.n_kv_heads, cfg.head_dim)
        k = torch.zeros(shape, dtype=self.dtype, device=self.device)
        return {"k": k, "v": torch.zeros_like(k),
                "len": torch.zeros(batch, dtype=torch.int32, device=self.device)}

    # ---------------- prefill ----------------
    @torch.no_grad()
    def prefill(self, inputs, lengths=None, max_len: Optional[int] = None, enc_inputs=None):
        """Run the full prompt.  inputs: token ids (B, S), or float
        embeddings (B, S, d) (the vision stub's; M-RoPE then takes the text
        positions 0 .. S − 1, as JAX's ``prefill`` does).  Returns ``(logits,
        cache)`` with logits (B, 1, V) float32 at each row's last valid token.

        Attention stacks: the cache holds the rotated K and the V of every
        layer, ``{"k", "v"}`` of shape (n_layers, B, S, Hk, hd) — or, given
        ``max_len``, placed at the start of zeroed (n_layers, B, max_len, Hk,
        hd) buffers as ``init_cache`` lays them out (JAX's
        ``_fill_kv_cache``) — plus ``"len"`` (B,) int32.  ``lengths`` (B,):
        valid prompt lengths of a right-padded batch; causal attention keeps
        the padding out of the valid prefix, logits are gathered at
        ``lengths - 1`` and ``len`` is set per row.

        RWKV6 stacks: the cache is the recurrent state after the last token,
        ``{"shift_tm", "shift_cm", "wkv"}`` as ``init_cache`` lays it out.

        RG-LRU hybrids: the mixed cache of ``init_cache`` for ``max_len``
        (default S).  A sliding-window layer's ring of ``S_buf`` slots holds
        the last ``min(S, S_buf)`` keys, key p at slot ``p % S_buf``, as
        JAX's ``_fill_kv_cache`` places them; the RG-LRU layers' ``conv``
        and ``h`` are their states after the last token.

        ``lengths`` raises ``ValueError`` on RWKV6 and hybrid stacks, as
        JAX's assertion does: a recurrent state would advance through the
        padding.

        Encoder-decoders: ``enc_inputs`` (B, S_enc, d) runs the encoder
        first; each decoder layer's cross K/V join the cache as
        ``cross_k``/``cross_v`` (n_layers, B, S_enc, Hk, hd) with
        ``cross_len`` = S_enc for every row.  (JAX's ``prefill`` sets every
        int32 leaf of its cache to ``lengths`` when they are given, the
        cross ``len`` among them, so its later decode steps read only the
        first ``lengths[b]`` encoder frames; the port keeps all of them,
        as JAX's own cache without ``lengths`` does.)
        """
        x = self._embed_in(inputs)
        B, S = x.shape[:2]
        if (self.recurrent or self.hybrid) and lengths is not None:
            raise ValueError("variable-length prefill requires attention-only models")
        if self.recurrent:
            states = []
            for blk in self.blocks:
                x, st = blk(x)
                states.append(st)
            shift_tm, shift_cm, wkv = (torch.stack(t) for t in zip(*states))
            return self._logits(x[:, -1:]), {"shift_tm": shift_tm, "shift_cm": shift_cm,
                                             "wkv": wkv}
        rope = self._rope(self._positions(B, S))
        enc_out = self._run_encoder(enc_inputs) if self.encoder is not None else None
        ks, vs, convs, hs, cks, cvs = [], [], [], [], [], []
        for blk in self.blocks:
            if isinstance(blk, RGLRUBlock):
                x, (conv, h) = blk(x)
                convs.append(conv)
                hs.append(h)
                continue
            a, (k, v) = attention_full(blk.attn, self.cfg, blk.n1(x), rope, window=blk.window,
                                       shard=self.shard)
            x = x + a
            if blk.cross is not None:
                c, (ck, cv) = attention_full(blk.cross, self.cfg, blk.nc(x), None,
                                             kv_source=enc_out, shard=self.shard)
                x = x + c
                cks.append(ck)
                cvs.append(cv)
            x = x + blk.ffn(x)[0]
            ks.append(k)
            vs.append(v)
        if lengths is not None:
            # the cache's own copy: decode steps advance it in place
            lengths = lengths.to(device=self.device, dtype=torch.int32, copy=True)
            last = x[torch.arange(B, device=self.device), lengths.long() - 1][:, None]
        else:
            lengths = torch.full((B,), S, dtype=torch.int32, device=self.device)
            last = x[:, -1:]
        k, v = torch.stack(ks), torch.stack(vs)
        if self.hybrid:
            size = S if max_len is None else max_len
            size = min(size, self.kv_window or size)
            take = min(S, size)
            slots = torch.arange(S - take, S, device=self.device) % size
            buf_k = k.new_zeros((*k.shape[:2], size, *k.shape[3:]))
            buf_v = torch.zeros_like(buf_k)
            buf_k[:, :, slots] = k[:, :, S - take:]
            buf_v[:, :, slots] = v[:, :, S - take:]
            return self._logits(last), {"k": buf_k, "v": buf_v, "len": lengths,
                                        "conv": torch.stack(convs), "h": torch.stack(hs)}
        if max_len is not None:
            take = min(S, max_len)
            buf_k = k.new_zeros((*k.shape[:2], max_len, *k.shape[3:]))
            buf_v = torch.zeros_like(buf_k)
            buf_k[:, :, :take] = k[:, :, :take]
            buf_v[:, :, :take] = v[:, :, :take]
            k, v = buf_k, buf_v
        cache = {"k": k, "v": v, "len": lengths}
        if enc_out is not None:
            cache.update(cross_k=torch.stack(cks), cross_v=torch.stack(cvs),
                         cross_len=torch.full((B,), enc_out.shape[1], dtype=torch.int32,
                                              device=self.device))
        return self._logits(last), cache

    # ---------------- decode ----------------
    @torch.no_grad()
    def decode_step(self, tokens, cache: dict, table=None):
        """tokens: (B, 1) int, or float embeddings (B, 1, d) (the vision
        stub's; M-RoPE takes the text position ``len``, the same id three
        times, as JAX's decode does).  Returns logits (B, 1, V) float32 and
        advances ``cache`` by one token, in place.

        Attention stacks: ``table`` (B, n_cols) int32 switches the layers onto
        the paged cache of :meth:`init_paged_cache` (entries >= n_pages
        unmapped), one table for every layer; without it the cache is the
        contiguous one of :meth:`init_cache` (or a horizon view of it, its
        sequence axis sliced).  Each row's K/V is written at
        ``cache["len"]`` and ``len`` advances by one.

        RWKV6 stacks: the cache is the recurrent state of :meth:`init_cache`
        or :meth:`prefill`; every layer's states are replaced by the next
        ones.  RG-LRU hybrids: the mixed cache of :meth:`init_cache` or
        :meth:`prefill`; a sliding-window layer writes its ring at slot
        ``len % S_buf``, an RG-LRU layer replaces its ``conv`` and ``h``.  A
        ``table`` raises ``ValueError`` on both: recurrent state and ring
        buffers have no paged form.

        Encoder-decoders: after its self-attention each decoder layer
        attends to its ``cross_k``/``cross_v`` over ``cross_len`` frames
        (the encoder ran at prefill; nothing of it is written).  A
        ``table`` raises ``ValueError``: JAX pages decoder-only stacks only.

        Every new state is copied into the cache's own tensors, which are
        never replaced and never read on the host, so a CUDA graph captured
        over steps on one cache replays them on the same memory.
        """
        x = self._embed_in(tokens)
        if (self.recurrent or self.hybrid or self.encoder is not None) and table is not None:
            raise ValueError("paged KV cache requires a decoder-only global-attention stack")
        if self.recurrent:
            for i, blk in enumerate(self.blocks):
                x, (shift_tm, shift_cm, wkv) = blk(x, cache["shift_tm"][i],
                                                   cache["shift_cm"][i], cache["wkv"][i])
                cache["shift_tm"][i].copy_(shift_tm)
                cache["shift_cm"][i].copy_(shift_cm)
                cache["wkv"][i].copy_(wkv)
            return self._logits(x)
        pos = cache["len"]
        rope = self._rope(pos[:, None])
        for blk, j in zip(self.blocks, self.cache_index):
            if isinstance(blk, RGLRUBlock):
                x, (conv, h) = blk(x, cache["conv"][j], cache["h"][j])
                cache["conv"][j].copy_(conv)
                cache["h"][j].copy_(h)
                continue
            x = x + attention_decode(blk.attn, self.cfg, blk.n1(x), cache["k"][j],
                                     cache["v"][j], pos, table, rope, window=blk.window)
            if blk.cross is not None:
                x = x + attention_cross_decode(blk.cross, self.cfg, blk.nc(x),
                                               cache["cross_k"][j], cache["cross_v"][j],
                                               cache["cross_len"])
            x = x + blk.ffn(x, exact=True)[0]
        cache["len"] += 1
        return self._logits(x)

    @torch.no_grad()
    def decode_span(self, tokens, cache: dict, table=None):
        """tokens: (B, S) int, a short run of S new tokens appended in one
        call (speculative verification).  Returns logits (B, S, V) float32,
        position i's those of the token after ``tokens[:, i]``, and advances
        ``cache`` by S tokens, in place.  ``table`` as in :meth:`decode_step`.

        Decoder-only global-attention stacks, as in the JAX package
        (``_block_span``): a recurrent or hybrid model (the only stacks with
        a sliding-window layer) or an encoder-decoder (cross-attention)
        raises ``ValueError``.  The span is S :meth:`decode_step`
        calls, so its logits and cache are theirs bit for bit: the JAX
        package's contract, which makes the speculative stream the target's
        own.  One product over the B·S rows would round a row otherwise on
        the card (``chip_smoke.py``'s ``span_rounding`` shows where), so a
        single-pass span waits for a batch-invariant product.
        """
        if self.recurrent or self.hybrid:
            raise ValueError("decode_span supports global-attention blocks only")
        if self.encoder is not None:
            raise ValueError("decode_span does not support cross-attention")
        return torch.cat([self.decode_step(tokens[:, i:i + 1], cache, table)
                          for i in range(tokens.shape[1])], dim=1)
