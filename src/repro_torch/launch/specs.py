"""Inputs of the stub frontends, made from a seed.

Counterpart of the JAX package's ``launch/specs.py`` for what the port
needs of it: the encoder's frame count ``AUDIO_ENC_FRAMES`` and the shapes
of the inputs a model takes (``batch_inputs``, ``prefill_inputs``,
``decode_inputs``), which there are abstract ``ShapeDtypeStruct``s and here
tensors drawn from a numpy seed.  Both frontends are stubs in the JAX
package too: the audio encoder takes precomputed frame embeddings (B,
frames, d_model) and the vision-language trunk precomputed patch-and-text
embeddings (B, S, d_model).  ``mrope_positions`` gives the three M-RoPE ids
of a text-image-text sequence by Qwen2-VL's rule.  The per-cell sharding
presets of the JAX module belong to the mesh, which is not ported yet.
Every maker puts its tensors on the card unless ``device`` says otherwise
(the tests pass ``device="cpu"``).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig
from repro_torch.device import resolve_device

__all__ = ["AUDIO_ENC_FRAMES", "enc_len_for", "frame_embeddings", "patch_embeddings",
           "mrope_positions", "batch_inputs", "prefill_inputs", "decode_inputs"]

# encoder frame count for the enc-dec audio arch (≈30 s at 50 Hz + margin)
AUDIO_ENC_FRAMES = 1536

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def enc_len_for(cfg: ModelConfig) -> int:
    """The encoder frames a prefill of ``cfg`` takes: 0 without an encoder."""
    return AUDIO_ENC_FRAMES if cfg.enc_dec else 0


def _normal(shape, seed: int, cfg: ModelConfig, device) -> torch.Tensor:
    x = np.random.default_rng(seed).standard_normal(shape, dtype=np.float32)
    return torch.from_numpy(x).to(device=resolve_device(device), dtype=_DTYPES[cfg.dtype])


def frame_embeddings(cfg: ModelConfig, batch: int, seed: int, n_frames: int = AUDIO_ENC_FRAMES,
                     device="cuda") -> torch.Tensor:
    """The audio stub's frame embeddings (batch, n_frames, d_model), N(0, 1)
    from ``seed``, in the model dtype."""
    return _normal((batch, n_frames, cfg.d_model), seed, cfg, device)


def patch_embeddings(cfg: ModelConfig, batch: int, seq: int, seed: int,
                     device="cuda") -> torch.Tensor:
    """The vision stub's patch-and-text embeddings (batch, seq, d_model),
    N(0, 1) from ``seed``, in the model dtype."""
    return _normal((batch, seq, cfg.d_model), seed, cfg, device)


def mrope_positions(text_before: int, grid_h: int, grid_w: int, text_after: int) -> torch.Tensor:
    """The (3, S) int32 temporal, height and width ids of ``text_before``
    text tokens, one image of ``grid_h`` × ``grid_w`` patches (row-major)
    and ``text_after`` text tokens, S = text_before + grid_h·grid_w +
    text_after, by Qwen2-VL's rule (arXiv:2409.12191 §2.1): text token i has
    t = h = w = i; the image starts at s = text_before, patch (r, c) at t =
    s, h = s + r, w = s + c; the text after it resumes at s + max(grid_h,
    grid_w), one more the token."""
    s = text_before
    before = np.broadcast_to(np.arange(s), (3, s))
    rows, cols = np.divmod(np.arange(grid_h * grid_w), grid_w)
    image = np.stack([np.full(grid_h * grid_w, s), s + rows, s + cols])
    after = np.broadcast_to(s + max(grid_h, grid_w) + np.arange(text_after), (3, text_after))
    return torch.from_numpy(np.concatenate([before, image, after], axis=1).astype(np.int32))


def _tokens(cfg: ModelConfig, shape, seed: int, device) -> torch.Tensor:
    ids = np.random.default_rng(seed).integers(0, cfg.vocab_size, shape).astype(np.int32)
    return torch.from_numpy(ids).to(resolve_device(device))


def batch_inputs(cfg: ModelConfig, batch: int, seq: int, seed: int, device="cuda") -> dict:
    """A training batch as JAX's ``batch_inputs`` shapes it: ``labels``
    (batch, seq); ``tokens`` (batch, seq), or the vision stub's ``embeds``
    (batch, seq, d_model); an encoder-decoder also ``enc_embeds`` (batch,
    min(AUDIO_ENC_FRAMES, seq), d_model)."""
    out = {"labels": _tokens(cfg, (batch, seq), seed + 1, device)}
    if cfg.frontend == "vision" and not cfg.enc_dec:
        out["embeds"] = patch_embeddings(cfg, batch, seq, seed, device)
    else:
        out["tokens"] = _tokens(cfg, (batch, seq), seed, device)
    if cfg.enc_dec:
        out["enc_embeds"] = frame_embeddings(cfg, batch, seed + 2, min(AUDIO_ENC_FRAMES, seq),
                                             device)
    return out


def prefill_inputs(cfg: ModelConfig, batch: int, seq: int, seed: int, device="cuda") -> dict:
    """A prefill's inputs as JAX's ``prefill_inputs`` shapes them:
    ``tokens`` (batch, seq) ids, or the vision stub's (batch, seq, d_model)
    embeddings; an encoder-decoder also ``enc_embeds`` (batch,
    AUDIO_ENC_FRAMES, d_model)."""
    out = {"tokens": (patch_embeddings(cfg, batch, seq, seed, device)
                      if cfg.frontend == "vision" else _tokens(cfg, (batch, seq), seed, device))}
    if cfg.enc_dec:
        out["enc_embeds"] = frame_embeddings(cfg, batch, seed + 2, device=device)
    return out


def decode_inputs(cfg: ModelConfig, batch: int, seed: int, device="cuda") -> dict:
    """A decode step's input as JAX's ``decode_inputs`` shapes it: ``tokens``
    (batch, 1) ids, or the vision stub's (batch, 1, d_model) embedding."""
    if cfg.frontend == "vision":
        return {"tokens": patch_embeddings(cfg, batch, 1, seed, device)}
    return {"tokens": _tokens(cfg, (batch, 1), seed, device)}
