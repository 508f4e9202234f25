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
import zipfile
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch
from numpy.lib import format as npformat

__all__ = ["save_state", "load_state", "latest_step", "CheckpointManager"]

_READERS = min(8, os.cpu_count() or 1)     # threads a restore reads with
_DTYPES = {str(d): d for d in (torch.float32, torch.bfloat16, torch.int32, torch.int64)}


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _from_numpy(a: np.ndarray, dtype: torch.dtype) -> torch.Tensor:
    a = np.require(a, requirements=("C", "W"))      # a copy only if it is not already so
    if dtype == torch.bfloat16:
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a).to(dtype)


def save_state(state: dict, directory: str, step: int, metadata: Optional[dict] = None) -> str:
    """Atomically save ``state`` ({name: tensor}) as ``<directory>/step_<step>``."""
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"tmp.{step}.{os.getpid()}")
    final = os.path.join(directory, f"step_{step:012d}")
    os.makedirs(tmp, exist_ok=True)
    # the layout np.savez writes (one uncompressed ``<name>.npy`` member a
    # leaf), a leaf copied to the host at a time, so a 30 GB state never
    # sits in host memory whole
    with open(os.path.join(tmp, "arrays.npz"), "wb") as f:
        with zipfile.ZipFile(f, mode="w", compression=zipfile.ZIP_STORED,
                             allowZip64=True) as zf:
            for k, v in state.items():
                with zf.open(f"{k}.npy", "w", force_zip64=True) as member:
                    npformat.write_array(member, _to_numpy(v), allow_pickle=False)
        f.flush()
        os.fsync(f.fileno())
    meta = {"step": step, "time": time.time(), "n_leaves": len(state),
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
    """Read the checkpoint of ``step`` (default the latest) into ``template``'s
    own tensors (same names) in place, a leaf at a time, so a restore holds
    no second copy of the state on the device.  Up to ``_READERS`` threads
    read the leaves, each through its own handle on the archive (the zip
    member's CRC and the copies release the GIL).  Returns ``(template,
    step)``; raises ``FileNotFoundError`` when there is none and ``KeyError``
    when the names differ."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint in {directory}")
    path = os.path.join(directory, f"step_{step:012d}")
    with open(os.path.join(path, "meta.json")) as f:
        dtypes = json.load(f).get("dtypes", {})
    npz = os.path.join(path, "arrays.npz")
    with np.load(npz) as data:
        if set(data.files) != set(template):
            raise KeyError(f"checkpoint {path} holds {sorted(set(data.files) ^ set(template))} "
                           f"that the template does not, or the reverse")

    def read(leaves):
        with np.load(npz) as data, torch.no_grad():
            for k, t in leaves:
                t.copy_(_from_numpy(data[k], _DTYPES.get(dtypes.get(k), t.dtype)))

    # largest first, dealt round the readers, so their shares come out even
    leaves = sorted(template.items(), key=lambda kv: -kv[1].numel() * kv[1].element_size())
    n = max(1, min(_READERS, len(leaves)))
    with ThreadPoolExecutor(n) as pool:
        for done in [pool.submit(read, leaves[i::n]) for i in range(n)]:
            done.result()
    return template, step


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
