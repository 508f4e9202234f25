"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each source under ``repro_torch/csrc/`` is compiled on its own into a shared
library with a plain C interface::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

into ``build/repro_torch_kernels/`` at the root of the checkout (listed in
``.gitignore``).  A library is built at its first use and cached under a hash
of the sources and flags, so a changed source builds anew and an unchanged one
is loaded as it is.  ``build_all`` starts one ``nvcc`` per source, all at
once.  ``ptxas``'s register and shared-memory report is kept beside each
library as ``<library>.log``.

Nothing here runs when the module is imported: the CPU tests import every
module of the port, and there is no ``nvcc`` on a machine without a card.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
SOURCES = ("flash_attention", "paged_attention", "decode_attention", "rwkv6_scan",
           "rglru_scan", "flash_attention_bwd", "rwkv6_scan_bwd", "rglru_scan_bwd")
NVCC_FALLBACK = "/usr/local/cuda/bin/nvcc"     # the CUDA toolkit's default location
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of ``nvcc``: on ``PATH``, else the toolkit's default location."""
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists(NVCC_FALLBACK):
        nvcc = NVCC_FALLBACK
    if nvcc is None:
        raise RuntimeError(f"nvcc was found neither on PATH nor at {NVCC_FALLBACK}; the CUDA "
                           f"kernels are built only on a machine with the CUDA toolkit")
    return nvcc


def library_path(name: str) -> Path:
    """Where the library of ``name`` lives for the current sources and flags."""
    if name not in SOURCES:
        raise KeyError(f"unknown kernel source {name!r}; known: {SOURCES}")
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode())
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, one ``nvcc``
    per source, all started together.  Returns the seconds each build took
    (0.0 for a library that was already there); raises ``RuntimeError`` with
    the compiler's output if any build fails."""
    todo = [n for n in names if not library_path(n).exists()]
    took = {n: 0.0 for n in names}
    if not todo:
        return took
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        out = library_path(n)
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, out)
    errors = []
    for n, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        took[n] = time.perf_counter() - t0
        Path(f"{out}.log").write_text(log)
        if proc.returncode != 0:
            errors.append(f"nvcc failed on {n}.cu (exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)     # atomic: a reader never sees half a library
    if errors:
        raise RuntimeError("\n".join(errors))
    return took


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if it is missing."""
    lib = _loaded.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(library_path(name)))
        _loaded[name] = lib
    return lib
