"""Weight bridge: the JAX package's parameter tree -> the port's state dict.

Input is the JAX ``Model.init`` tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), its flat form keyed by ``/``-joined
tree paths, or a ``save_pytree`` ``arrays.npz`` (see :func:`load_npz`) — no
JAX is needed to read any of them.  The mapping:

* ``blocks/b0/<leaf>`` leaves are layer-stacked (axis 0 = layer, the scan
  axis of the JAX model) and are unstacked into ``blocks.<i>.<leaf>`` —
  attention blocks' ``attn.*``/``mlp.*`` and RWKV6 blocks' ``tm.*``/``cm.*``
  alike (``tm.mix_b`` keeps its (5, rank, d) and ``tm.u`` its (H, hd));
* every other leaf keeps its path with ``/`` turned into ``.``;
* weights keep the ``(d_in, d_out)`` layout of ``apply_dense`` — the port
  applies ``x @ w`` — so no leaf is transposed; ``embed`` and ``lm_head``
  carry the vocab padded to a multiple of 32, as there.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.config import ModelConfig

__all__ = ["flatten_tree", "load_npz", "state_from_jax"]

_STACK = "blocks/b0/"


def flatten_tree(tree, prefix: str = "") -> dict[str, np.ndarray]:
    """Nested dict of arrays -> ``{"a/b/c": array}``, the key format of the
    JAX package's checkpoints."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    flat: dict = {}
    for key, sub in tree.items():
        flat.update(flatten_tree(sub, f"{prefix}/{key}" if prefix else str(key)))
    return flat


def load_npz(path) -> dict[str, np.ndarray]:
    """Read a ``save_pytree`` ``arrays.npz`` into the flat ``{path: array}``
    form :func:`state_from_jax` takes."""
    with np.load(path) as data:
        return {k: data[k] for k in data.files}


def _to_tensor(a) -> torch.Tensor:
    a = np.array(a)                  # a writable, contiguous copy
    # numpy has no bfloat16: JAX hands bf16 leaves over as ml_dtypes'
    # bfloat16 and npz stores them as raw 2-byte records; both are the bits
    if a.dtype.itemsize == 2 and a.dtype.kind not in "iuf":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def state_from_jax(params, cfg: ModelConfig, device="cpu") -> dict[str, torch.Tensor]:
    """The port's ``Model`` state dict, on ``device``, holding the weights of
    the JAX parameter tree ``params`` (nested or flat).  Raises if a layer
    stack does not have ``cfg.n_layers`` layers or a key is of an unported
    kind (``rem<j>`` tails, an encoder)."""
    state: dict[str, torch.Tensor] = {}
    for key, arr in flatten_tree(params).items():
        t = _to_tensor(arr)
        if key.startswith(_STACK):
            if t.shape[0] != cfg.n_layers:
                raise ValueError(f"{key}: {t.shape[0]} stacked layers, config has "
                                 f"{cfg.n_layers}")
            leaf = key[len(_STACK):].replace("/", ".")
            for i in range(cfg.n_layers):
                state[f"blocks.{i}.{leaf}"] = t[i]
        elif key.startswith(("blocks/", "rem", "encoder")):
            raise NotImplementedError(f"{key}: only single-kind stacks are ported")
        else:
            state[key.replace("/", ".")] = t
    return {k: v.to(device) for k, v in state.items()}
