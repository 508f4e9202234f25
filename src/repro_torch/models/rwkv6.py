"""RWKV6 ("Finch") blocks of the port: time-mix with data-dependent decay,
and channel-mix.

Counterpart of the JAX package's ``models/rwkv6.py`` (arXiv:2404.05892):
token shift with data-dependent linear interpolation (ddlerp, LoRA-style),
per-channel decay ``w_t = exp(−exp(ŵ_t))``, the WKV6 recurrence
(``ops.wkv6``: the CUDA kernel on the card), per-head GroupNorm and the SiLU
output gate; channel-mix keys with a squared ReLU.  Parameter names, shapes,
init schemes and rounding points are the JAX package's, so the weight bridge
copies its leaves as they are.

Both mixes run the same code over a whole sequence (prefill) and over one
token (decode): the token shift reads the previous token from the carried
state, and the WKV state carries in fp32.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Dense, empty_param, init_normal_, init_uniform_

_MIX_NAMES = ("r", "k", "v", "w", "g")
_LORA_RANK = 32
_DECAY_LORA_RANK = 64


def _token_shift(x, shift_state):
    """x: (B, S, d) -> the previous token of every position: the carried
    ``shift_state`` (B, d), or zeros, before the first."""
    B, _, d = x.shape
    prev = (torch.zeros((B, 1, d), dtype=x.dtype, device=x.device) if shift_state is None
            else shift_state[:, None, :].to(x.dtype))
    return torch.cat([prev, x[:, :-1]], dim=1)


class TimeMix(nn.Module):
    """Time-mix parameters: ddlerp (``mix_base``, ``mix_a``, ``mix_b``),
    the r/k/v/g/o projections, the decay LoRA (``w0``, ``w_a``, ``w_b``),
    the bonus ``u`` and the GroupNorm's ``gn_scale``/``gn_bias``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        d, hd = cfg.d_model, cfg.rwkv_head_dim
        self.n_heads, self.head_dim = d // hd, hd
        n_mix = len(_MIX_NAMES)
        self.mix_base = empty_param((n_mix, d), dtype, device)
        self.mix_a = empty_param((d, _LORA_RANK), dtype, device)
        self.mix_b = empty_param((n_mix, _LORA_RANK, d), dtype, device)
        for name in ("r", "k", "v", "g", "o"):
            setattr(self, name, Dense(d, d, bias=False, dtype=dtype, device=device))
        self.w0 = empty_param((d,), dtype, device)
        self.w_a = empty_param((d, _DECAY_LORA_RANK), dtype, device)
        self.w_b = empty_param((_DECAY_LORA_RANK, d), dtype, device)
        self.u = empty_param((self.n_heads, hd), dtype, device)
        self.gn_scale = empty_param((d,), dtype, device)
        self.gn_bias = empty_param((d,), dtype, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX ``init_time_mix`` schemes, in its order of leaves."""
        self.mix_base.zero_()
        init_normal_(self.mix_a, generator, 0.1)
        init_normal_(self.mix_b, generator, 0.1)
        for name in ("r", "k", "v", "g", "o"):
            getattr(self, name).init(generator)
        init_uniform_(self.w0, generator, 0.5)
        init_normal_(self.w_a, generator, 0.1)
        init_normal_(self.w_b, generator, 0.1)
        init_uniform_(self.u, generator, 0.5)
        self.gn_scale.fill_(1.0)
        self.gn_bias.zero_()

    def _ddlerp(self, x, xx):
        """One mixed input per target of ``_MIX_NAMES``."""
        delta = xx - x
        base = torch.tanh((x + delta * 0.5) @ self.mix_a)             # (B, S, rank)
        return [x + delta * (self.mix_base[i] + base @ self.mix_b[i])
                for i in range(len(_MIX_NAMES))]

    def _group_norm(self, x, eps: float = 1e-5):
        """GroupNorm over heads: x (B, S, d), statistics in fp32 per head."""
        B, S, d = x.shape
        xh = x.reshape(B, S, self.n_heads, self.head_dim).float()
        mu = xh.mean(-1, keepdim=True)
        var = (xh - mu).square().mean(-1, keepdim=True)
        xh = (xh - mu) * torch.rsqrt(var + eps)
        out = xh.reshape(B, S, d) * self.gn_scale.float() + self.gn_bias.float()
        return out.to(x.dtype)

    def forward(self, x, shift_state=None, wkv_state=None):
        """x: (B, S, d); shift_state: (B, d) or None; wkv_state: (B, H, hd,
        hd) fp32 or None.  Returns (out, (new shift state, new wkv state))."""
        B, S, d = x.shape
        H, hd = self.n_heads, self.head_dim
        xr, xk, xv, xw, xg = self._ddlerp(x, _token_shift(x, shift_state))
        r = self.r(xr).reshape(B, S, H, hd)
        k = self.k(xk).reshape(B, S, H, hd)
        v = self.v(xv).reshape(B, S, H, hd)
        g = F.silu(self.g(xg))
        w_raw = self.w0 + torch.tanh(xw @ self.w_a) @ self.w_b
        w = torch.exp(-torch.exp(w_raw.float())).reshape(B, S, H, hd)
        out, wkv_state = ops.wkv6(r, k, v, w, self.u, wkv_state)
        out = self._group_norm(out.reshape(B, S, d))
        return self.o(out * g), (x[:, -1, :], wkv_state)


class ChannelMix(nn.Module):
    """``sigmoid(r(xr)) · v(relu(k(xk))²)`` over token-shifted inputs."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        d, ff = cfg.d_model, cfg.d_ff
        self.mix_k = empty_param((d,), dtype, device)
        self.mix_r = empty_param((d,), dtype, device)
        self.k = Dense(d, ff, bias=False, dtype=dtype, device=device)
        self.v = Dense(ff, d, bias=False, dtype=dtype, device=device)
        self.r = Dense(d, d, bias=False, dtype=dtype, device=device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        self.mix_k.zero_()
        self.mix_r.zero_()
        for lin in (self.k, self.v, self.r):
            lin.init(generator)

    def forward(self, x, shift_state=None):
        """x: (B, S, d); shift_state: (B, d) or None.  Returns (out, new
        shift state)."""
        delta = _token_shift(x, shift_state) - x
        xk = x + delta * self.mix_k
        xr = x + delta * self.mix_r
        kk = torch.square(F.relu(self.k(xk)))
        return torch.sigmoid(self.r(xr)) * self.v(kk), x[:, -1, :]
