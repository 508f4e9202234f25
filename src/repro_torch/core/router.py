"""Utility-without-batching estimators û_{i,k,1} (§4, "Estimation of the
Utility Without Batching").

Two routers, exactly as in the paper: a three-layer MLP trained with
multi-label BCE over (query embedding → per-model correctness), and a KNN
classifier.  Both map a query embedding to a vector of K estimated utilities
in [0, 1].

The MLP is a ``torch.nn.Module`` on a device (the card unless ``"cpu"`` is
asked), initialised with the JAX package's threefry draws
(:mod:`repro_torch.utils.prng`), so from one seed both frameworks start
from the same weights; the minibatch order is numpy's, as there.  The KNN
router is numpy on both sides.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.training.optimizer import adamw
from repro_torch.utils import prng

__all__ = ["MLPRouter", "KNNRouter", "train_mlp_router", "init_mlp_params",
           "router_from_params"]


def init_mlp_params(seed: int, dims: Sequence[int], device) -> list:
    """The JAX router's init: per layer, ``key, sub = split(key)``, w ~
    N(0, 1)·√(2/fan_in) from ``sub``, b = 0.  Returns [(w (a, b), b (b,))]."""
    key = prng.as_words(prng.prng_key(seed))
    params = []
    for a, b in zip(dims[:-1], dims[1:]):
        key, sub = prng.split(key)
        scale = float(np.sqrt(np.float32(2.0 / a)))
        w = prng.normal(sub, (a, b)) * scale
        params.append((w.to(device), torch.zeros(b, dtype=torch.float32, device=device)))
    return params


class MLPRouter(torch.nn.Module):
    """Three-layer MLP multi-label classifier (paper default): ReLU between
    layers, ``h @ w + b`` as the JAX router computes it."""

    def __init__(self, params: list, embed_dim: int, n_models: int):
        super().__init__()
        self.w = torch.nn.ParameterList([torch.nn.Parameter(w) for w, _ in params])
        self.b = torch.nn.ParameterList([torch.nn.Parameter(b) for _, b in params])
        self.embed_dim = embed_dim
        self.n_models = n_models

    @property
    def device(self) -> torch.device:
        return self.w[0].device

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        for w, b in zip(list(self.w)[:-1], list(self.b)[:-1]):
            h = torch.relu(h @ w + b)
        return h @ self.w[-1] + self.b[-1]

    def predict(self, embeddings: np.ndarray) -> np.ndarray:
        """û_{i,k,1} ∈ [0,1]^{n×K}."""
        x = torch.as_tensor(np.asarray(embeddings, dtype=np.float32), device=self.device)
        with torch.no_grad():
            return torch.sigmoid(self(x)).cpu().numpy().astype(np.float64)


def router_from_params(params: list, device="cuda") -> MLPRouter:
    """An :class:`MLPRouter` holding the JAX router's parameters: its
    ``params`` list of ``{"w", "b"}`` arrays (numpy or anything numpy reads)."""
    dev = resolve_device(device)
    ts = [(torch.tensor(np.asarray(p["w"], dtype=np.float32), device=dev),
           torch.tensor(np.asarray(p["b"], dtype=np.float32), device=dev)) for p in params]
    return MLPRouter(ts, embed_dim=ts[0][0].shape[0], n_models=ts[-1][0].shape[1])


def _bce_loss(router: MLPRouter, x, y):
    logits = router(x)
    return -torch.mean(y * F.logsigmoid(logits) + (1 - y) * F.logsigmoid(-logits))


def train_mlp_router(
    embeddings: np.ndarray,        # (n, d) training query embeddings
    labels: np.ndarray,            # (n, K) ground-truth u_{i,k,1} ∈ {0,1}
    hidden: Sequence[int] = (256, 128),
    lr: float = 1e-3,
    weight_decay: float = 1e-4,
    epochs: int = 60,
    batch_size: int = 256,
    seed: int = 0,
    val_frac: float = 0.1,
    device="cuda",
) -> MLPRouter:
    """Minimize multi-label BCE on Q' (§4); early selection on a val split."""
    dev = resolve_device(device)
    x = torch.as_tensor(np.asarray(embeddings, dtype=np.float32), device=dev)
    y = torch.as_tensor(np.asarray(labels, dtype=np.float32), device=dev)
    n, d = x.shape
    k = y.shape[1]
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_val = max(1, int(n * val_frac))
    vi = torch.as_tensor(perm[:n_val], device=dev)
    ti = perm[n_val:]

    router = MLPRouter(init_mlp_params(seed, (d, *hidden, k), dev), embed_dim=d, n_models=k)
    params = list(router.parameters())
    opt = adamw(lr, weight_decay=weight_decay, grad_clip=1.0)
    state = opt.init([p.detach() for p in params])

    best = (np.inf, [p.detach().clone() for p in params])
    for epoch in range(epochs):
        order = rng.permutation(ti)
        for s in range(0, len(order), batch_size):
            sel = torch.as_tensor(order[s:s + batch_size], device=dev)
            loss = _bce_loss(router, x[sel], y[sel])
            grads = torch.autograd.grad(loss, params)
            state = opt.update(list(grads), state, [p.detach() for p in params])[1]
        with torch.no_grad():
            val = float(_bce_loss(router, x[vi], y[vi]))
        if val < best[0]:
            best = (val, [p.detach().clone() for p in params])
    with torch.no_grad():
        for p, q in zip(params, best[1]):
            p.copy_(q)
    return router


@dataclass
class KNNRouter:
    """K-nearest-neighbour multi-label classifier (paper alternative)."""

    train_embeddings: np.ndarray   # (n, d), assumed L2-normalized
    train_labels: np.ndarray       # (n, K)
    k: int = 16

    def predict(self, embeddings: np.ndarray) -> np.ndarray:
        q = np.asarray(embeddings, dtype=np.float32)
        sims = q @ self.train_embeddings.T            # cosine (normalized)
        k = min(self.k, sims.shape[1])                # tiny train sets: k ≤ n
        nn = np.argpartition(-sims, k - 1, axis=1)[:, :k]
        return self.train_labels[nn].mean(axis=1).astype(np.float64)

    @property
    def n_models(self) -> int:
        return self.train_labels.shape[1]
