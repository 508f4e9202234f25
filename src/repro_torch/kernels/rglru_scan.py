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
across calls, one a device and stream, and the kernel leaves it zeroed.

Training adds the backward, which the JAX package takes as ``jax.grad`` of
``_rglru_jnp``: with g_t = sqrt(max(1 − exp(2a_t), 1e-12)) and δ_t the
gradient reaching h_t (from the output and from h_{t+1})::

    δ_t = ∂h_t + exp(a_{t+1}) · δ_{t+1}
    ∂x_t = g_t · δ_t
    ∂a_t = δ_t · (exp(a_t) · h_{t−1}) + (δ_t · x_t) · ∂g_t/∂a_t,
    ∂g/∂a = −exp(2a) / g, zero where the clamp holds g at 1e-6

and ∂state = exp(a_0) · δ_0.  h_{t−1} is the fp32 state, rebuilt from
the inputs by the forward's own steps, never the rounded output.
``rglru_backward_cuda`` launches ``csrc/rglru_scan_bwd.cu`` (chunk blocks of
``CHUNK`` tokens as the forward's, chained twice: forward, saving the state
entering each chunk, then in reverse, each chunk rebuilding its states from
the saved start and handing δ's carry to the chunk before),
``rglru_backward_plain`` is the same arithmetic in plain fp32 PyTorch, each
product and sum rounded apart in the order above, and :class:`RGLRU` joins
forward and backward for autograd.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.scratch import held_zeros

__all__ = ["rglru_cuda", "rglru_plain", "CHUNK", "rglru_backward_cuda", "rglru_backward_plain",
           "RGLRU"]

CHUNK = 16                   # tokens a chunk block of the kernel (csrc/rglru_scan.cu)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def _chain_words(device, stream, B, W, n_chunks):
    """The chain's scratch for launches on ``stream``, the forward's and the
    backward's: word 0 the ticket counter, then one 8-byte word a (chunk
    but the last, row, channel), held zero across calls, one set a device
    and stream (``scratch.held_zeros``)."""
    return held_zeros("rglru_cuda: the chain scratch", device, stream,
                      1 + (n_chunks - 1) * B * W, torch.int64)


def rglru_cuda(x, a_log, state=None):
    """Launch the CUDA RG-LRU scan.  x: (B, T, W) contiguous, float32 or
    bfloat16; a_log: (B, T, W) contiguous float32 (a bf16 gate would move the
    result away from the reference); state: (B, W) contiguous float32, or
    None for zeros.  All on one CUDA device.  Returns ``(h (B, T, W) in x's
    dtype, final state (B, W) float32)`` as new tensors.  Raises on anything
    else, and counts each launch in ``rglru_cuda.launches``.  At T > CHUNK
    the launch uses the chain scratch of the device and the current stream
    (``_chain_words``): one 8-byte word a (chunk but the last, row,
    channel), plus a counter."""
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
    stream = torch.cuda.current_stream(x.device).cuda_stream
    words = None if n_chunks == 1 else _chain_words(x.device, stream, B, W, n_chunks).data_ptr()
    err = lib.repro_rglru_scan(x.data_ptr(), a_log.data_ptr(), state.data_ptr(),
                               out.data_ptr(), h_out.data_ptr(), words, B, T, W,
                               _DTYPE_CODE[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"rglru_cuda: launch failed with CUDA error {err}")
    launches.count(rglru_cuda)
    return out, h_out


rglru_cuda.launches = 0


def rglru_backward_plain(x, a_log, d_h, state=None, d_state=None):
    """Gradients of :func:`rglru_plain` at (x, a_log, state) given the
    output's gradient ``d_h`` (B, T, W) and the final state's ``d_state``
    (B, W) or None (zeros).  Returns ``(dx in x's dtype, da_log float32,
    d_state0 float32)``.

    The gates as the forward takes them (exp(2a) correctly rounded), the
    states rebuilt by its steps, then the reverse sweep of the module
    docstring token by token in fp32.
    """
    B, T, W = x.shape
    h = (torch.zeros((B, W), dtype=torch.float32, device=x.device) if state is None
         else state.float())
    al = a_log.float()
    a = torch.exp(al)
    e2 = torch.exp(2.0 * al.double()).float()            # correctly rounded
    one_m = 1.0 - e2
    g = torch.sqrt(torch.clamp_min(one_m, 1e-12))
    dg = torch.where(one_m >= 1e-12, -(e2 / g), 0.0)
    xf = x.float()
    gated = g * xf
    h_in = torch.empty((B, T, W), dtype=torch.float32, device=x.device)
    for t in range(T):
        h_in[:, t] = h
        h = a[:, t] * h + gated[:, t]
    carry = (torch.zeros((B, W), dtype=torch.float32, device=x.device) if d_state is None
             else d_state.float())
    dh = d_h.float()
    dx = torch.empty((B, T, W), dtype=torch.float32, device=x.device)
    da = torch.empty_like(dx)
    for t in reversed(range(T)):
        d = dh[:, t] + carry
        dx[:, t] = g[:, t] * d
        da[:, t] = d * (a[:, t] * h_in[:, t]) + (d * xf[:, t]) * dg[:, t]
        carry = a[:, t] * d
    return dx.to(x.dtype), da, carry


def _lib_bwd() -> ctypes.CDLL:
    lib = build.load("rglru_scan_bwd")
    fn = lib.repro_rglru_scan_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def rglru_backward_cuda(x, a_log, d_h, state=None, d_state=None):
    """Launch the CUDA RG-LRU backward.  x and d_h: (B, T, W) contiguous of
    one dtype, float32 or bfloat16; a_log: (B, T, W) contiguous float32;
    state and d_state: (B, W) contiguous float32, or None for zeros.  All on
    one CUDA device.  Returns ``(dx, da_log, d_state0)`` as
    :func:`rglru_backward_plain` does.  Raises on anything else, and counts
    each call in ``rglru_backward_cuda.launches``.  At T > CHUNK the state
    entering each chunk (B·ceil(T / CHUNK)·W floats) takes a scratch from
    the caching allocator, and the chains use the chain scratch of the
    device and the current stream (``_chain_words``, shared with the
    forward and left zero).
    Shapes and dtypes are checked before the device."""
    B, T, W = x.shape
    named = [("x", x), ("a_log", a_log), ("d_h", d_h)]
    named += [(n, t) for n, t in (("state", state), ("d_state", d_state)) if t is not None]
    if x.dtype not in _DTYPE_CODE or d_h.dtype != x.dtype:
        raise ValueError(f"rglru_backward_cuda: x and d_h must share float32 or bfloat16, got "
                         f"{x.dtype}, {d_h.dtype}")
    if a_log.dtype != torch.float32 or any(t is not None and t.dtype != torch.float32
                                           for t in (state, d_state)):
        raise ValueError("rglru_backward_cuda: a_log, state and d_state must be float32")
    if (x.dim() != 3 or a_log.shape != x.shape or d_h.shape != x.shape
            or any(t is not None and tuple(t.shape) != (B, W) for t in (state, d_state))):
        raise ValueError(f"rglru_backward_cuda: shapes x {tuple(x.shape)}, a_log "
                         f"{tuple(a_log.shape)}, d_h {tuple(d_h.shape)} are not (B, T, W) x3 "
                         f"with states (B, W)")
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"rglru_backward_cuda: {name} is on {t.device}, not a CUDA device")
        if t.device != x.device:
            raise ValueError(f"rglru_backward_cuda: {name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"rglru_backward_cuda: {name} must be contiguous")
    dx, da = torch.empty_like(x), torch.empty_like(a_log)
    d_state0 = torch.empty((B, W), dtype=torch.float32, device=x.device)
    if B * W == 0:
        return dx, da, d_state0
    if T == 0:
        return dx, da, (d_state0.zero_() if d_state is None else d_state0.copy_(d_state))
    lib = _lib_bwd()
    n_chunks = -(-T // CHUNK)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    h_start = words = None
    if n_chunks > 1:      # freed on return: the allocator reuses it only after this stream's work
        h_start = torch.empty((B, n_chunks, W), dtype=torch.float32, device=x.device)
        words = _chain_words(x.device, stream, B, W, n_chunks)
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    err = lib.repro_rglru_scan_bwd(x.data_ptr(), a_log.data_ptr(), ptr(state),
                                   d_h.data_ptr(), ptr(d_state),
                                   dx.data_ptr(), da.data_ptr(), d_state0.data_ptr(),
                                   ptr(h_start), ptr(words), B, T, W, _DTYPE_CODE[x.dtype],
                                   stream)
    if err != 0:
        raise RuntimeError(f"rglru_backward_cuda: launch failed with CUDA error {err}")
    launches.count(rglru_backward_cuda)
    return dx, da, d_state0


rglru_backward_cuda.launches = 0


class RGLRU(torch.autograd.Function):
    """The RG-LRU scan with its gradient: forward and backward each take the
    kernel on a CUDA tensor and the plain version on a CPU one.  The
    forward saves its inputs; the backward rebuilds the fp32 states.
    ``ops.rglru_scan`` routes here only when grad is enabled and an input
    requires it, so serving never builds a node."""

    @staticmethod
    def forward(ctx, x, a_log, state):
        fwd = rglru_plain if x.device.type == "cpu" else rglru_cuda
        h, h_out = fwd(x, a_log, state)
        ctx.save_for_backward(x, a_log, state)
        ctx.set_materialize_grads(False)
        return h, h_out

    @staticmethod
    def backward(ctx, d_h, d_state):
        x, a_log, state = ctx.saved_tensors
        d_h = torch.zeros_like(x) if d_h is None else d_h.contiguous()
        if d_state is not None:
            d_state = d_state.contiguous()
        bwd = rglru_backward_plain if x.device.type == "cpu" else rglru_backward_cuda
        dx, da, d_state0 = bwd(x, a_log, d_h, state, d_state)
        return dx, da, (d_state0 if state is not None else None)
