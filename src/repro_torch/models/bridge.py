"""Weight bridge: the JAX package's parameter tree -> the port's state dict.

Input is the JAX ``Model.init`` tree as numpy arrays
(``jax.tree.map(np.asarray, params)``), its flat form keyed by ``/``-joined
tree paths, or a ``save_pytree`` ``arrays.npz`` (see :func:`load_npz`) — no
JAX is needed to read any of them.  The mapping:

* ``blocks/b<s>/<leaf>`` leaves are stacked over the ``n_groups = n_layers //
  P`` repeats of the block pattern (P = ``len(block_pattern)``; axis 0 is the
  scan axis of the JAX model): group g's slice goes to layer ``g·P + s`` as
  ``blocks.<i>.<leaf>`` — attention blocks' ``attn.*``/``mlp.*``, RWKV6
  blocks' ``tm.*``/``cm.*`` (``tm.mix_b`` keeps its (5, rank, d) and
  ``tm.u`` its (H, hd)) and RG-LRU blocks' ``rec.*`` alike;
* ``rem<j>/<leaf>`` leaves are the unrolled tail that the pattern does not
  divide (RecurrentGemma-9B's 38 = 12·3 + 2): layer ``n_groups·P + j``;
* an encoder-decoder's ``encoder/blocks/b0/<leaf>`` leaves are stacked over
  its ``n_encoder_layers``: slice g goes to ``encoder.blocks.<g>.<leaf>``,
  and ``encoder/norm/<leaf>`` to ``encoder.norm.<leaf>``; its decoder
  blocks' ``nc`` and ``cross`` leaves follow the block rule above;
* every other leaf keeps its path with ``/`` turned into ``.``;
* weights keep the ``(d_in, d_out)`` layout of ``apply_dense`` — the port
  applies ``x @ w`` — so no leaf is transposed; ``embed`` and ``lm_head``
  carry the vocab padded to a multiple of 32, as there.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from repro_torch.config import ModelConfig

__all__ = ["flatten_tree", "load_npz", "state_from_jax"]

_STACK = re.compile(r"blocks/b(\d+)/(.+)")
_TAIL = re.compile(r"rem(\d+)/(.+)")
_ENCODER = re.compile(r"encoder/blocks/b0/(.+)")


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
    the JAX parameter tree ``params`` (nested or flat).  Raises
    ``ValueError`` if a stacked leaf does not hold ``n_layers // P`` groups
    (an encoder leaf ``n_encoder_layers``), a pattern slot or tail index
    names no layer of ``cfg``, or an encoder leaf comes for a config without
    an encoder."""
    P = len(cfg.block_pattern)
    n_groups = cfg.n_layers // P
    n_tail = cfg.n_layers - n_groups * P
    state: dict[str, torch.Tensor] = {}
    for key, arr in flatten_tree(params).items():
        t = _to_tensor(arr)
        stack, tail, enc = _STACK.fullmatch(key), _TAIL.fullmatch(key), _ENCODER.fullmatch(key)
        if key.startswith("encoder/") and not cfg.enc_dec:
            raise ValueError(f"{key}: an encoder leaf, but {cfg.name} has no encoder")
        if enc:
            leaf = enc[1].replace("/", ".")
            if t.shape[0] != cfg.n_encoder_layers:
                raise ValueError(f"{key}: {t.shape[0]} stacked encoder layers, config has "
                                 f"{cfg.n_encoder_layers}")
            for g in range(cfg.n_encoder_layers):
                state[f"encoder.blocks.{g}.{leaf}"] = t[g]
        elif stack:
            slot, leaf = int(stack[1]), stack[2].replace("/", ".")
            if slot >= P or t.shape[0] != n_groups:
                raise ValueError(f"{key}: {t.shape[0]} stacked groups at slot {slot}, config "
                                 f"has {n_groups} groups of {P} ({cfg.n_layers} layers)")
            for g in range(n_groups):
                state[f"blocks.{g * P + slot}.{leaf}"] = t[g]
        elif tail:
            j, leaf = int(tail[1]), tail[2].replace("/", ".")
            if j >= n_tail:
                raise ValueError(f"{key}: tail layer {j}, config has {n_tail} tail layers")
            state[f"blocks.{n_groups * P + j}.{leaf}"] = t
        elif key.startswith("blocks/") or (key.startswith("encoder/")
                                            and not key.startswith("encoder/norm/")):
            raise ValueError(f"{key}: not a leaf of a block stack")
        else:
            state[key.replace("/", ".")] = t
    return {k: v.to(device) for k, v in state.items()}
