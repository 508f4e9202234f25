"""Dense MLP of the port: the gated forms SwiGLU and GeGLU and the ungated
forms GELU and squared ReLU (Nemotron) (counterpart of the JAX package's
``models/mlp.py``)."""
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


def relu2(x):
    """Squared ReLU, ``square(relu(x))``."""
    return torch.square(F.relu(x))


GATED = {"swiglu": F.silu, "geglu": gelu}
UNGATED = {"gelu": gelu, "relu2": relu2}


class MLP(nn.Module):
    """Gated, ``down(act(gate(x)) · up(x))`` with act SiLU (SwiGLU) or
    tanh-GELU (GeGLU); ungated, ``down(act(up(x)))`` with act tanh-GELU
    (``gelu``) or squared ReLU (``relu2``), and no ``gate`` leaf, as JAX's
    tree has none."""

    def __init__(self, cfg: ModelConfig, *, dtype, device):
        super().__init__()
        if cfg.activation not in GATED and cfg.activation not in UNGATED:
            raise NotImplementedError(f"activation {cfg.activation!r} is not ported yet")
        self.act = GATED.get(cfg.activation) or UNGATED[cfg.activation]
        d, ff = cfg.d_model, cfg.d_ff
        self.gate = (Dense(d, ff, bias=False, dtype=dtype, device=device)
                     if cfg.activation in GATED else None)
        self.up = Dense(d, ff, bias=False, dtype=dtype, device=device)
        self.down = Dense(ff, d, bias=False, dtype=dtype, device=device)

    def init(self, generator: torch.Generator) -> None:
        for lin in (self.gate, self.up, self.down):
            if lin is not None:
                lin.init(generator)

    def forward(self, x):
        if self.gate is None:
            return self.down(self.act(self.up(x)))
        return self.down(self.act(self.gate(x)) * self.up(x))
