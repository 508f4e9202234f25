"""RG-LRU scan: the CUDA kernel's wrapper and its plain version.

The RecurrentGemma gated diagonal recurrence, per channel, with an fp32
state h::

    h_t = exp(a_t) · h_{t−1} + sqrt(max(1 − exp(2·a_t), 1e-12)) · x_t

where ``a_t = a_log_t ≤ 0``.  ``rglru_cuda`` launches ``csrc/rglru_scan.cu``,
the port of the JAX package's ``rglru_pallas``.  ``rglru_plain`` is the same
function in plain PyTorch: the CPU path and the reference the kernel is held
against on the card.  Both evaluate the TPU kernel's own expression in fp32
(``1 − exp(2a)`` clamped at 1e-12, not ``−expm1(2a)``, which differs where
``a`` lies within ~1e-6 of 0) and take every decay as ``exp`` of a
non-positive number; the state carries in fp32 and the outputs are rounded
once to x's dtype.

One value is computed wider: ``exp(2a)`` is taken in fp64 and rounded once to
fp32, i.e. correctly rounded.  Where ``a`` lies within ~1e-6 of 0, ``1 −
exp(2a)`` keeps only the few bits that ``exp`` rounds, and one unit in the
last place of ``exp`` moves the gate by up to ~1e-4 relative, and fp32
``exp`` implementations differ by that unit (PyTorch's vectorized CPU
``exp`` is one unit off for some such inputs where XLA's CPU ``exp``, which
the JAX package's tests run, is correctly rounded), so only a correctly
rounded value makes the plain version, the kernel and the reference agree.
The kernel takes it so only where ``2a > −0.5``; below, it takes ``a · a``,
which moves the gate by < 2.1e-7 relative.

The kernel splits the tokens into chunks of ``CHUNK``, one block each, and
chains them in one launch: each chunk walks its tokens from the state its
predecessor's walk ended in, so it steps the plain version's recurrence;
it is bit-identical to the plain version wherever every ``2a > −0.5`` and
within a few units of the gates elsewhere.  The chain's scratch is held
here across calls, one a device, and the kernel leaves it zeroed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches

__all__ = ["rglru_cuda", "rglru_plain", "CHUNK"]

CHUNK = 16                   # tokens a chunk block of the kernel (csrc/rglru_scan.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_scratch: dict[torch.device, torch.Tensor] = {}


def rglru_plain(x, a_log, state=None):
    """x: (B, T, W) in the model dtype; a_log: (B, T, W) ≤ 0, float32; state:
    (B, W) float32 or None (zeros).  Returns ``(h (B, T, W) in x's dtype,
    final state (B, W) float32)``.

    The decays ``exp(a_log)`` and the gated inputs are computed for every
    token at once, as in the TPU kernel's chunk; the recurrence then steps
    token by token in fp32, which is the oracle's order of operations.
    """
    B, T, W = x.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=x.device) if state is None
         else state.float())
    al = a_log.float()
    a = torch.exp(al)
    e2 = torch.exp(2.0 * al.double()).float()            # correctly rounded
    gated = torch.sqrt(torch.clamp_min(1.0 - e2, 1e-12)) * x.float()
    out = torch.empty((B, T, W), dtype=torch.float32, device=x.device)
    for t in range(T):
        h = a[:, t] * h + gated[:, t]
        out[:, t] = h
    return out.to(x.dtype), h


def _lib() -> ctypes.CDLL:
    lib = build.load("rglru_scan")
    fn = lib.repro_rglru_scan
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        if lib.repro_rglru_chunk() != CHUNK:
            raise RuntimeError(f"rglru_scan: the library's chunk {lib.repro_rglru_chunk()} is "
                               f"not CHUNK = {CHUNK}")
    return lib


def _chain_scratch(device, n_words):
    """The chain's scratch on ``device``: at least ``n_words`` words of 8 bytes,
    zero before the first launch and left zero by every launch, so it is
    allocated once (and again only to grow) and held across calls.  A CUDA
    graph bakes its address in, so growing it while the stream is captured
    raises: run the shape once eagerly first."""
    buf = _scratch.get(device)
    if buf is None or buf.numel() < n_words:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"rglru_cuda: the chain scratch on {device} must grow to "
                               f"{n_words} words while the stream is captured; run this shape "
                               f"once eagerly before capturing it")
        buf = torch.zeros(n_words, dtype=torch.int64, device=device)
        _scratch[device] = buf
    return buf


def rglru_cuda(x, a_log, state=None):
    """Launch the CUDA RG-LRU scan.  x: (B, T, W) contiguous, float32 or
    bfloat16; a_log: (B, T, W) contiguous float32 (a bf16 gate would move the
    result away from the reference); state: (B, W) contiguous float32, or
    None for zeros.  All on one CUDA device.  Returns ``(h (B, T, W) in x's
    dtype, final state (B, W) float32)`` as new tensors.  Raises on anything
    else, and counts each launch in ``rglru_cuda.launches``.  At T > CHUNK
    the launch uses the device's chain scratch (``_chain_scratch``): one
    8-byte word a (chunk but the last, row, channel), plus a counter."""
    B, T, W = x.shape
    if state is None:
        state = torch.zeros((B, W), dtype=torch.float32, device=x.device)
    for name, t in (("x", x), ("a_log", a_log), ("state", state)):
        if t.device.type != "cuda":
            raise ValueError(f"rglru_cuda: {name} is on {t.device}, not a CUDA device")
        if t.device != x.device:
            raise ValueError(f"rglru_cuda: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_cuda: {name} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"rglru_cuda: x must be float32 or bfloat16, got {x.dtype}")
    if a_log.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"rglru_cuda: a_log and state must be float32, got {a_log.dtype}, "
                         f"{state.dtype}")
    if a_log.shape != x.shape or tuple(state.shape) != (B, W):
        raise ValueError(f"rglru_cuda: shapes x {tuple(x.shape)}, a_log {tuple(a_log.shape)}, "
                         f"state {tuple(state.shape)} are not (B, T, W) x2 and (B, W)")
    out = torch.empty_like(x)
    h_out = torch.empty_like(state)
    if B * W == 0:
        return out, h_out
    if T == 0:
        h_out.copy_(state)
        return out, h_out
    lib = _lib()
    n_chunks = -(-T // CHUNK)
    scratch = (None if n_chunks == 1
               else _chain_scratch(x.device, 1 + (n_chunks - 1) * B * W).data_ptr())
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.repro_rglru_scan(x.data_ptr(), a_log.data_ptr(), state.data_ptr(),
                               out.data_ptr(), h_out.data_ptr(), scratch, B, T, W,
                               _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rglru_cuda: launch failed with CUDA error {err}")
    launches.count(rglru_cuda)
    return out, h_out


rglru_cuda.launches = 0
