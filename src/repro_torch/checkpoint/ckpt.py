"""Atomic checkpoints of the port's training state, in the JAX package's
on-disk layout (``checkpoint/ckpt.py`` there).

* A checkpoint is ``<dir>/step_<step:012d>/arrays.npz`` plus ``meta.json``,
  written first to ``<dir>/tmp.<step>.<pid>``, fsynced, and committed by one
  rename, so a crash mid-write never corrupts the latest good checkpoint;
* :func:`latest_step` reads only committed ``step_*`` directories, so a
  partial write is ignored;
* :class:`CheckpointManager` keeps the last ``keep``.

The state is a flat dict ``{name: tensor}``; the trainer keys it by the
port's state names (``params/<parameter name>``, ``opt/mu/<name>``,
``opt/nu/<name>``, ``opt/step``).  bfloat16 tensors are stored as raw
2-byte records, as numpy holds JAX's bfloat16 leaves, and ``meta.json``
records each leaf's dtype.  Model weights that JAX's ``save_pytree`` wrote
come in through ``models/bridge.py`` (``load_npz``, ``state_from_jax``).
"""
from __future__ import annotations

import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

__all__ = ["save_state", "load_state", "latest_step", "CheckpointManager"]

_DTYPES = {str(d): d for d in (torch.float32, torch.bfloat16, torch.int32, torch.int64)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.array(a).view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(dtype)


def save_state(state: dict, directory: str, step: int, metadata: Optional[dict] = None) -> str:
    """Atomically save ``state`` ({name: tensor}) as ``<directory>/step_<step>``."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:012d}")
    os.makedirs(tmp, exist_ok=True)
    arrays = {k: _to_numpy(v) for k, v in state.items()}
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    meta = {"step": step, "time": time.time(), "n_leaves": len(arrays),
            "dtypes": {k: str(v.dtype) for k, v in state.items()}, **(metadata or {})}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                     # atomic commit
    return final


def latest_step(directory: str) -> Optional[int]:
    """The largest committed step in ``directory``, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(directory) if d.startswith("step_")]
    return max(steps) if steps else None


def load_state(template: dict, directory: str, step: Optional[int] = None):
    """Read the checkpoint of ``step`` (default the latest) into new tensors
    with the dtype and device of ``template``'s (same names).  Returns
    ``(state, step)``; raises ``FileNotFoundError`` when there is none and
    ``KeyError`` when the names differ."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:012d}")
    with open(os.path.join(path, "meta.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    with np.load(os.path.join(path, "arrays.npz")) as data:
        if set(data.files) != set(template):
            raise KeyError(f"checkpoint {path} holds {sorted(set(data.files) ^ set(template))} "
                           f"that the template does not, or the reverse")
        out = {}
        for k, t in template.items():
            saved = _DTYPES.get(dtypes.get(k), t.dtype)
            out[k] = _from_numpy(data[k], saved).to(device=t.device, dtype=t.dtype)
    return out, step


class CheckpointManager:
    """Keep-N manager with resume support."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = directory
        self.keep = keep

    def save(self, state: dict, step: int, metadata: Optional[dict] = None) -> str:
        path = save_state(state, self.directory, step, metadata)
        self._gc()
        return path

    def restore(self, template: dict, step: Optional[int] = None):
        return load_state(template, self.directory, step)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def _gc(self):
        steps = sorted(int(d.split("_")[1]) for d in os.listdir(self.directory)
                       if d.startswith("step_"))
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:012d}"), ignore_errors=True)
