"""Device selection shared by the port's entry points.

Entry points take an explicit ``device`` that defaults to ``"cuda"``; with no
card present that default raises instead of quietly running on the CPU.  The
CPU is used only when a caller asks for it (the tests do), and there every
kernel wrapper takes its plain PyTorch version.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return ``device`` as a ``torch.device`` with its index filled in
    (``"cuda"`` becomes the current card), raising if it is a card that is
    absent.

    On the card this also turns TF32 off for matrix products and cuDNN: the
    port is held against the JAX package at float32 tolerances, and TF32
    keeps only about three decimal digits.  ``"meta"`` (shapes without
    storage) is accepted too, to build a model only to count its
    parameters.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} was requested but no CUDA device is "
                f"available; pass device='cpu' to run on the CPU")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {str(device)!r}: use 'cuda' or 'cpu'")
    return dev
