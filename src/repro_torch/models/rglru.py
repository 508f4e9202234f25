"""RecurrentGemma / Griffin recurrent block of the port (arXiv:2402.19427).

Counterpart of the JAX package's ``models/rglru.py``: x → [gate branch:
linear → GeLU] ⊙ [linear → causal conv1d (width ``conv_width``) → RG-LRU] →
linear out, with ``a_t = exp(−8·softplus(Λ)·σ(W_a u_t))`` and
``h_t = a_t·h_{t−1} + sqrt(1 − a_t²)·(σ(W_x u_t) ⊙ u_t)``.  The recurrence is
``ops.rglru_scan`` (the CUDA kernel on the card).  Parameter names, shapes,
init schemes and rounding points are the JAX package's, so the weight bridge
copies its leaves as they are:

* the conv is the elementwise shifted sum in the model dtype, oldest tap
  first (not ``F.conv1d``, whose taps run the other way and which cuDNN
  computes in TF32 for fp32);
* ``a_log`` is fp32: the sigmoid of the fp32 cast of a model-dtype product,
  times the fp32 softplus of ``lambda``, times −8;
* the scan's input is cast to the model dtype, its state is fp32, its output
  comes back in the model dtype; the conv state stays in the model dtype.

The same code runs over a whole sequence (prefill) and over one token
(decode): the conv reads its history from the carried state.
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models.layers import Dense, empty_param, init_normal_, init_uniform_
from repro_torch.models.mlp import gelu

__all__ = ["RGLRU", "causal_conv"]

_C = 8.0


def causal_conv(w, bias, x, state=None):
    """Per-channel causal conv.  w: (cw, W); bias: (W,); x: (B, S, W); state:
    (B, cw − 1, W) history or None (zeros).  Returns (out (B, S, W), new
    state: the last cw − 1 inputs)."""
    cw = w.shape[0]
    B, S, W = x.shape
    prev = (torch.zeros((B, cw - 1, W), dtype=x.dtype, device=x.device) if state is None
            else state.to(x.dtype))
    xp = torch.cat([prev, x], dim=1)                      # (B, S + cw − 1, W)
    out = sum(xp[:, i:i + S] * w[i] for i in range(cw)) + bias
    return out.to(x.dtype), xp[:, -(cw - 1):]


class RGLRU(nn.Module):
    """The recurrent branch's leaves: ``in_gate``, ``in_rec``, ``conv_w``
    (cw, W), ``conv_b``, ``gate_a``, ``gate_x``, ``lambda`` (W,) and ``out``.
    (``lambda`` is a Python keyword: reach it with ``getattr``.)"""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        d = cfg.d_model
        W = cfg.lru_width or d
        self.in_gate = Dense(d, W, bias=False, dtype=dtype, device=device)
        self.in_rec = Dense(d, W, bias=False, dtype=dtype, device=device)
        self.conv_w = empty_param((cfg.conv_width, W), dtype, device)
        self.conv_b = empty_param((W,), dtype, device)
        self.gate_a = Dense(W, W, bias=False, dtype=dtype, device=device)
        self.gate_x = Dense(W, W, bias=False, dtype=dtype, device=device)
        self.register_parameter("lambda", empty_param((W,), dtype, device))
        self.out = Dense(W, d, bias=False, dtype=dtype, device=device)

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> None:
        """The JAX ``init_rglru_block`` schemes, in its order of leaves."""
        self.in_gate.init(generator)
        self.in_rec.init(generator)
        init_normal_(self.conv_w, generator, 0.5)          # fan_in = cw
        self.conv_b.zero_()
        self.gate_a.init(generator)
        self.gate_x.init(generator)
        init_uniform_(getattr(self, "lambda"), generator, 1.0)
        self.out.init(generator)

    def _log_a(self, u):
        """log a_t = −8 · softplus(Λ) · σ(W_a u) ≤ 0, in fp32."""
        r = torch.sigmoid(self.gate_a(u).float())
        lam = getattr(self, "lambda").float()
        lam = torch.logaddexp(lam, torch.zeros_like(lam))  # softplus, as jax.nn.softplus
        return -_C * lam * r

    def forward(self, x, conv_state=None, h_state=None):
        """x: (B, S, d); conv_state: (B, cw − 1, W) or None; h_state: (B, W)
        fp32 or None.  Returns (out, (new conv state, new h state))."""
        gate = gelu(self.in_gate(x))
        u = self.in_rec(x)
        u, conv_state = causal_conv(self.conv_w, self.conv_b, u, conv_state)
        a_log = self._log_a(u)
        gate_x = torch.sigmoid(self.gate_x(u).float())
        inp = (gate_x * u.float()).to(x.dtype)
        h, h_state = ops.rglru_scan(inp, a_log, h_state)
        return self.out(h * gate), (conv_state, h_state)

