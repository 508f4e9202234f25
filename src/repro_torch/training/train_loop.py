"""Training loop of the port: the train step with gradient accumulation, and
the host-side ``Trainer`` with checkpoint/restart.

Counterpart of the JAX package's ``training/train_loop.py`` on one device:
its ``make_train_step`` and ``Trainer``.  The mesh's partition specs (data
parallelism, ZeRO-1, FSDP) wait for the mesh slice.  Where JAX's step is a
pure function over a parameter pytree, the port's parameters are the
model's own (``nn.Parameter``s by state name, grad turned on by
:func:`trainable`): the step computes the gradients with autograd, takes
the AdamW update functionally and copies it into the parameters in place,
as JAX donates them to its jit.  On the card the model's attention runs
the flash forward and backward kernels (``kernels.flash_attention``).
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import torch
from torch import nn

from repro_torch.checkpoint import CheckpointManager
from repro_torch.models.transformer import Model
from repro_torch.training.optimizer import Optimizer, OptimizerState

__all__ = ["trainable", "make_train_step", "train_state", "Trainer"]


def trainable(model: nn.Module) -> dict[str, nn.Parameter]:
    """The model's parameters by state name, with ``requires_grad`` turned
    on in place (a serving model keeps it off)."""
    model.requires_grad_(True)
    return dict(model.named_parameters())


def _on_device(batch: dict, device: torch.device) -> dict:
    """Numpy arrays and tensors of a batch as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device, non_blocking=True) for k, v in batch.items()}


def make_train_step(model: Model, opt: Optimizer):
    """Returns ``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``, ``params`` as :func:`trainable` gives them, updated in place.

    ``model.shard`` is the step's one configuration (JAX's step takes a
    ``shard_cfg`` beside the model), read when the step runs: its
    ``remat`` in ``Model.forward``, and here its ``microbatches``
    (> 1 splits the batch on its leading axis and sums the gradients in
    ``acc_dtype``, one microbatch's activations alive at a time, then
    divides and casts them to float32, as JAX's scan does).  ``metrics``:
    ``loss`` and ``grad_norm`` (the global norm of the gradients before
    clipping), float32 tensors on the device.
    """
    def value_and_grad(leaves, batch):
        loss = model.loss(batch)
        return loss.detach(), torch.autograd.grad(loss, leaves)

    def train_step(params: dict, opt_state: OptimizerState, batch: dict):
        n_micro = model.shard.microbatches
        acc_dt = torch.bfloat16 if model.shard.acc_dtype == "bfloat16" else torch.float32
        leaves = list(params.values())
        batch = _on_device(batch, model.device)
        if n_micro > 1:
            b = batch["tokens"].shape[0]
            if b % n_micro:
                raise ValueError(f"batch of {b} rows does not split into {n_micro} microbatches")
            b //= n_micro
            gsum = [torch.zeros(p.shape, dtype=acc_dt, device=p.device) for p in leaves]
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for m in range(n_micro):
                loss, grads = value_and_grad(leaves, {k: v[m * b:(m + 1) * b]
                                                      for k, v in batch.items()})
                for a, g in zip(gsum, grads):
                    a.add_(g.to(acc_dt))
                lsum = lsum + loss
            grads = [(a / n_micro).to(torch.float32) for a in gsum]
            loss = lsum / n_micro
        else:
            loss, grads = value_and_grad(leaves, batch)
        grad_norm = torch.sqrt(sum(torch.sum(torch.square(g.to(torch.float32))) for g in grads))
        new, opt_state = opt.update(list(grads), opt_state, leaves)
        with torch.no_grad():
            for p, n in zip(leaves, new):
                p.copy_(n)
        return params, opt_state, {"loss": loss.to(torch.float32), "grad_norm": grad_norm}

    return train_step


def train_state(params: dict, opt_state: OptimizerState) -> dict:
    """The checkpointed state, keyed by the port's names: ``params/<name>``,
    ``opt/mu/<name>``, ``opt/nu/<name>`` and ``opt/step``."""
    state = {f"params/{n}": p.detach() for n, p in params.items()}
    for n, m, v in zip(params, opt_state.mu, opt_state.nu):
        state[f"opt/mu/{n}"] = m
        state[f"opt/nu/{n}"] = v
    state["opt/step"] = torch.tensor(opt_state.step, dtype=torch.int64)
    return state


@dataclass
class Trainer:
    """Host-side loop: batches in, checkpoints out, resume on restart.  The
    model's ``shard`` configures the step (:func:`make_train_step`)."""

    model: Model
    opt: Optimizer
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    keep: int = 3

    def __post_init__(self):
        self._step_fn = make_train_step(self.model, self.opt)
        self._mgr = CheckpointManager(self.ckpt_dir, self.keep) if self.ckpt_dir else None

    def init_state(self, generator: torch.Generator):
        """Fresh weights from ``generator`` (``Model.init``) and zero moments."""
        self.model.init(generator)
        params = trainable(self.model)
        return params, self.opt.init(list(params.values()))

    def restore_or_init(self, generator: torch.Generator):
        """``init_state``, then the latest checkpoint over it if there is one.
        Returns ``(params, opt_state, start_step)``."""
        params, opt_state = self.init_state(generator)
        start = 0
        if self._mgr and self._mgr.latest_step() is not None:
            state, start = self._mgr.restore(train_state(params, opt_state))
            with torch.no_grad():
                for n, p in params.items():
                    p.copy_(state[f"params/{n}"])
            opt_state = OptimizerState(step=int(state["opt/step"]),
                                       mu=[state[f"opt/mu/{n}"] for n in params],
                                       nu=[state[f"opt/nu/{n}"] for n in params])
        return params, opt_state, start

    def fit(self, params, opt_state, batches, start_step: int = 0, log_every: int = 10):
        """batches: iterable of batch dicts.  Returns (params, opt_state,
        history); a history entry (step, loss, grad_norm, seconds since the
        start) every ``log_every`` steps and at the first, the only steps
        that wait for the device.  A checkpoint every ``ckpt_every`` steps
        and after the last, unless that step was just saved or no step ran."""
        history = []
        t0 = time.time()
        step = saved = start_step
        for batch in batches:
            params, opt_state, metrics = self._step_fn(params, opt_state, batch)
            step += 1
            if step % log_every == 0 or step == start_step + 1:
                history.append({"step": step, "loss": float(metrics["loss"]),
                                "grad_norm": float(metrics["grad_norm"]),
                                "time": time.time() - t0})
            if self._mgr and step % self.ckpt_every == 0:
                self._mgr.save(train_state(params, opt_state), step)
                saved = step
        if self._mgr and step != saved:
            self._mgr.save(train_state(params, opt_state), step)
        return params, opt_state, history
