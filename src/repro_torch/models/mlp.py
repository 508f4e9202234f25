"""Dense MLP of the port: the gated forms SwiGLU and GeGLU (counterpart of the
JAX package's ``models/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Dense


def gelu(x):
    """``jax.nn.gelu``'s default, the tanh approximation
    ``0.5·x·(1 + tanh(sqrt(2/π)·(x + 0.044715·x³)))``; the exact (erf) GELU
    differs from it by up to ~5e-4."""
    return F.gelu(x, approximate="tanh")


_ACT = {"swiglu": F.silu, "geglu": gelu}


class MLP(nn.Module):
    """``down(act(gate(x)) · up(x))``, act SiLU (SwiGLU) or tanh-GELU (GeGLU)."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        if cfg.activation not in _ACT:
            raise NotImplementedError(f"activation {cfg.activation!r} is not ported yet")
        self.act = _ACT[cfg.activation]
        d, ff = cfg.d_model, cfg.d_ff
        self.gate = Dense(d, ff, bias=False, dtype=dtype, device=device)
        self.up = Dense(d, ff, bias=False, dtype=dtype, device=device)
        self.down = Dense(ff, d, bias=False, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for lin in (self.gate, self.up, self.down):
            lin.init(generator)

    def forward(self, x):
        return self.down(self.act(self.gate(x)) * self.up(x))
