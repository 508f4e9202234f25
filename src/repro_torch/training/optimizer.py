"""AdamW optimizer over a list of tensors, the port of the JAX package's
pytree optimizer (``training/optimizer.py`` there).

The API keeps the (init, update) pair, so the router trainer reads as its
JAX counterpart.  ``update`` is functional: it returns new parameter and
moment tensors and leaves its inputs alone.  The arithmetic is JAX's, in
the same order: moments in ``moment_dtype`` (float32 by default), the
update in float32, the bias corrections ``1 − β^t`` in float32.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Optional

import torch

__all__ = ["OptimizerState", "Optimizer", "clip_by_global_norm", "cosine_schedule", "adamw"]


class OptimizerState(NamedTuple):
    step: int                # updates taken
    mu: list                 # first moment, one tensor a parameter
    nu: list                 # second moment


@dataclass(frozen=True)
class Optimizer:
    init: Callable
    update: Callable


def clip_by_global_norm(grads: list, max_norm: float):
    """Scale every gradient by min(1, max_norm / (‖grads‖ + 1e-9)), the norm
    taken over all of them in float32.  Returns (clipped grads, norm)."""
    total = 0
    for g in grads:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    gnorm = torch.sqrt(total)
    scale = torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0)
    return [g * scale for g in grads], gnorm


def cosine_schedule(base_lr: float, warmup: int, total: int, min_ratio: float = 0.1):
    """Linear warmup to ``base_lr`` over ``warmup`` steps, then a cosine decay
    to ``min_ratio · base_lr`` at ``total``; a function of the step, computed
    in float32 as JAX's schedule, returned as a Python float."""
    f32 = torch.float32

    def lr(step):
        step = torch.tensor(float(step), dtype=f32)
        warm = base_lr * step / max(warmup, 1)
        t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = base_lr * (min_ratio + (1 - min_ratio) * 0.5
                         * (1 + torch.cos(torch.tensor(torch.pi, dtype=f32) * t)))
        return float(torch.where(step < warmup, warm, cos))

    return lr


def adamw(
    learning_rate: float | Callable = 1e-3,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    grad_clip: Optional[float] = None,
    moment_dtype=torch.float32,
) -> Optimizer:
    """AdamW with optional global-norm clipping; ``learning_rate`` is a
    number or a function of the (1-based) step."""
    lr_fn = learning_rate if callable(learning_rate) else (lambda _: learning_rate)

    def init(params: list) -> OptimizerState:
        return OptimizerState(step=0, mu=[torch.zeros_like(p, dtype=moment_dtype) for p in params],
                              nu=[torch.zeros_like(p, dtype=moment_dtype) for p in params])

    def update(grads: list, state: OptimizerState, params: list):
        if grad_clip is not None:
            grads, _ = clip_by_global_norm(grads, grad_clip)
        step = state.step + 1
        lr = lr_fn(step)
        t = torch.tensor(float(step), dtype=torch.float32)
        b1t = (1 - torch.tensor(b1, dtype=torch.float32) ** t).item()
        b2t = (1 - torch.tensor(b2, dtype=torch.float32) ** t).item()
        new_p, new_m, new_v = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            g32 = g.to(torch.float32)
            m32 = b1 * m.to(torch.float32) + (1 - b1) * g32
            v32 = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
            d = (m32 / b1t) / (torch.sqrt(v32 / b2t) + eps)
            if weight_decay:
                d = d + weight_decay * p.to(torch.float32)
            new_p.append((p.to(torch.float32) - lr * d).to(p.dtype))
            new_m.append(m32.to(moment_dtype))
            new_v.append(v32.to(moment_dtype))
        return new_p, OptimizerState(step=step, mu=new_m, nu=new_v)

    return Optimizer(init=init, update=update)
