"""AdamW optimizer over a list of tensors, the port of the JAX package's
pytree optimizer (``training/optimizer.py`` there).

The API keeps the (init, update) pair, so the router trainer reads as its
JAX counterpart.  ``update`` donates the parameters and the state, as the
JAX trainer's jit donates both: each tensor is overwritten in place with
its new value and the same tensors are returned, so a step keeps one copy
of them (at RWKV6-3B's width a second copy of its fp32 moments, 24.7 GB,
beside its weights would not fit one card).  The gradients are left
alone.  The arithmetic is JAX's, in the same order: moments in
``moment_dtype`` (float32 by default), the update in float32, the bias
corrections ``1 − β^t`` in float32.
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


def _clip_scale(grads: list, max_norm: float):
    """(min(1, max_norm / (‖grads‖ + 1e-9)), ‖grads‖), the norm taken over
    all of them in float32."""
    total = 0
    for g in grads:
        total = total + torch.sum(torch.square(g.to(torch.float32)))
    gnorm = torch.sqrt(total)
    return torch.clamp_max(max_norm / (gnorm + 1e-9), 1.0), gnorm


def clip_by_global_norm(grads: list, max_norm: float):
    """Scale every gradient by min(1, max_norm / (‖grads‖ + 1e-9)), the norm
    taken over all of them in float32.  Returns (clipped grads, norm)."""
    scale, gnorm = _clip_scale(grads, max_norm)
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

    @torch.no_grad()
    def update(grads: list, state: OptimizerState, params: list):
        """One step: returns ``(params, state)``, the same tensors updated in
        place.  A leaf at a time, so its float32 temporaries are the only
        memory it takes beside them; each product and sum is JAX's, rounded
        where JAX's is (in-place forms of the same operations)."""
        scale = _clip_scale(grads, grad_clip)[0] if grad_clip is not None else None
        step = state.step + 1
        lr = lr_fn(step)
        t = torch.tensor(float(step), dtype=torch.float32)
        b1t = (1 - torch.tensor(b1, dtype=torch.float32) ** t).item()
        b2t = (1 - torch.tensor(b2, dtype=torch.float32) ** t).item()
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            g32 = (g if scale is None else g * scale).to(torch.float32)
            m32 = m.to(torch.float32) * b1
            m32.add_(g32 * (1 - b1))
            v32 = v.to(torch.float32) * b2
            v32.add_(torch.square(g32).mul_(1 - b2))
            del g32
            d = torch.sqrt(v32 / b2t).add_(eps)
            d = torch.div(m32, b1t).div_(d)
            m.copy_(m32)                     # donated: rounded to moment_dtype in place
            v.copy_(v32)
            del m32, v32
            if weight_decay:
                d.add_(p.to(torch.float32) * weight_decay)
            d.mul_(lr)
            if p.dtype == torch.float32:
                p.sub_(d)
            else:
                p.copy_(p.to(torch.float32).sub_(d))
        return list(params), OptimizerState(step=step, mu=list(state.mu), nu=list(state.nu))

    return Optimizer(init=init, update=update)
