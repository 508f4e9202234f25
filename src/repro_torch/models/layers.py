"""Norms, projections, RoPE (and M-RoPE) and the parameter initializers.

Counterpart of the JAX package's ``models/layers.py``.  Weights keep that
package's layout: a projection's ``w`` is ``(d_in, d_out)`` and is applied as
``x @ w`` (not transposed, unlike ``nn.Linear``), so the weight bridge copies
leaves as they are.  The rounding points follow the JAX code: norms and RoPE
compute in fp32 and cast back to the activation dtype; projections and their
bias stay in the activation dtype.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn


def empty_param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device), requires_grad=False)


@torch.no_grad()
def init_normal_(p: torch.Tensor, generator: torch.Generator, scale: float = 1.0) -> None:
    """The JAX ``Builder``'s "normal" init: N(0, 1) · scale / sqrt(fan_in),
    fan_in = shape[-2] for matrices (shape[-1] for vectors), drawn in fp32
    and cast to the parameter's dtype.  One fp32 draw is the only temporary
    (scaled in place, cast by the copy): Nemotron-4-340B's 256,000 × 18,432
    output head is 18.9 GB of it, beside its 46.5 GB of bf16 weights on an
    80 GB card."""
    fan_in = p.shape[-2] if p.dim() >= 2 else p.shape[-1]
    z = torch.randn(p.shape, generator=generator, dtype=torch.float32,
                    device=generator.device)
    p.copy_(z.mul_(scale / np.sqrt(fan_in)))


@torch.no_grad()
def init_uniform_(p: torch.Tensor, generator: torch.Generator, scale: float) -> None:
    """The JAX ``Builder``'s "uniform" init: U(−scale, scale), drawn in fp32
    and cast to the parameter's dtype."""
    z = torch.rand(p.shape, generator=generator, dtype=torch.float32, device=generator.device)
    p.copy_((z * (2 * scale) - scale).to(device=p.device, dtype=p.dtype))


class Dense(nn.Module):
    """``x @ w (+ b)`` with ``w`` of shape ``(d_in, d_out)``."""

    def __init__(self, d_in: int, d_out: int, *, bias: bool, dtype, device):
        super().__init__()
        self.w = empty_param((d_in, d_out), dtype, device)
        self.b = empty_param((d_out,), dtype, device) if bias else None

    def init(self, generator: torch.Generator) -> None:
        init_normal_(self.w, generator)
        if self.b is not None:
            self.b.zero_()

    def forward(self, x):
        y = x @ self.w
        if self.b is not None:
            y = y + self.b
        return y


class RMSNorm(nn.Module):
    """``x · rsqrt(mean(x²) + eps) · scale`` in fp32, cast back to x's dtype."""

    def __init__(self, d: int, eps: float, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((d,), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        del generator
        self.scale.fill_(1.0)

    def forward(self, x):
        x32 = x.float()
        var = x32.square().mean(dim=-1, keepdim=True)
        return (x32 * torch.rsqrt(var + self.eps) * self.scale.float()).to(x.dtype)


class LayerNorm(nn.Module):
    """``(x − mean) · rsqrt(var + eps) · scale + bias`` in fp32 (population
    variance), cast back to x's dtype."""

    def __init__(self, d: int, eps: float, *, dtype, device):
        super().__init__()
        self.eps = eps
        self.scale = empty_param((d,), dtype, device)
        self.bias = empty_param((d,), dtype, device)

    def init(self, generator: torch.Generator) -> None:
        del generator
        self.scale.fill_(1.0)
        self.bias.zero_()

    def forward(self, x):
        x32 = x.float()
        mu = x32.mean(dim=-1, keepdim=True)
        var = (x32 - mu).square().mean(dim=-1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + self.eps) * self.scale.float()
        return (out + self.bias.float()).to(x.dtype)


def make_norm(kind: str, d: int, eps: float, *, dtype, device) -> nn.Module:
    """The norm ``cfg.norm`` names: ``rmsnorm`` or ``layernorm``."""
    if kind == "rmsnorm":
        return RMSNorm(d, eps, dtype=dtype, device=device)
    if kind == "layernorm":
        return LayerNorm(d, eps, dtype=dtype, device=device)
    raise NotImplementedError(f"norm {kind!r} is not ported yet")


def rope_freqs(head_dim: int, rotary_pct: float, theta: float) -> np.ndarray:
    rot = int(head_dim * rotary_pct) // 2 * 2
    return 1.0 / (theta ** (np.arange(0, rot, 2, dtype=np.float64) / rot))


def rope_tables(positions, inv_freq, sections=None):
    """The (cos, sin) tables of RoPE at ``positions`` (..., S), each of shape
    (..., S, 1, rot/2): angles in fp32, as in the JAX package.  Computed once
    per forward and shared by every layer.

    M-RoPE (Qwen2-VL, arXiv:2409.12191 §2.1): with ``sections`` (t, h, w),
    summing to rot/2, ``positions`` is (..., 3, S), the temporal, height and
    width ids of each token, and frequency band f takes the id of the
    section it falls in (the first t bands the temporal id, and so on), as
    JAX's ``apply_rope`` repeats them.  Each angle is the same fp32 product,
    so a text token (the same id three times) gets plain RoPE's table bit
    for bit."""
    if sections is not None:
        if sum(sections) != inv_freq.shape[-1]:
            raise ValueError(f"M-RoPE sections {tuple(sections)} do not sum to rot/2 = "
                             f"{inv_freq.shape[-1]}")
        which = torch.repeat_interleave(torch.arange(len(sections), device=positions.device),
                                        torch.tensor(sections, device=positions.device))
        positions = positions.index_select(-2, which).transpose(-1, -2)   # (..., S, rot/2)
        angles = positions.float() * inv_freq
    else:
        angles = positions[..., None].float() * inv_freq
    return torch.cos(angles)[..., None, :], torch.sin(angles)[..., None, :]


def apply_rope(x, tables):
    """x: (..., S, n_heads, head_dim); ``tables`` from :func:`rope_tables`, or
    None for no rotary part.  Rotate-half convention (HF Llama/Qwen):
    products in fp32, each rotated half cast back to x's dtype, the
    pass-through part left as it is."""
    if tables is None:
        return x
    cos, sin = tables
    half = cos.shape[-1]
    x1, x2, x_pass = x[..., :half], x[..., half:2 * half], x[..., 2 * half:]
    out1 = x1.float() * cos - x2.float() * sin
    out2 = x2.float() * cos + x1.float() * sin
    return torch.cat([out1.to(x.dtype), out2.to(x.dtype), x_pass], dim=-1)
