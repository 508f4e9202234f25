"""Dense MLP of the port: SwiGLU, the activation of the configs served so far
(counterpart of the JAX package's ``models/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.config import ModelConfig
from repro_torch.models.layers import Dense


class MLP(nn.Module):
    """``down(silu(gate(x)) · up(x))``."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        if cfg.activation != "swiglu":
            raise NotImplementedError(f"activation {cfg.activation!r} is not ported yet")
        d, ff = cfg.d_model, cfg.d_ff
        self.gate = Dense(d, ff, bias=False, dtype=dtype, device=device)
        self.up = Dense(d, ff, bias=False, dtype=dtype, device=device)
        self.down = Dense(ff, d, bias=False, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for lin in (self.gate, self.up, self.down):
            lin.init(generator)

    def forward(self, x):
        return self.down(F.silu(self.gate(x)) * self.up(x))
