"""RWKV6 WKV recurrence: the CUDA kernel's wrapper and its plain version.

The recurrence, per (row, head), with an fp32 (D, D) state S::

    o_t = r_t · (S + diag(u) k_tᵀ v_t)
    S  ← diag(w_t) S + k_tᵀ v_t

``wkv6_cuda`` launches ``csrc/rwkv6_scan.cu``, the port of the JAX
package's ``wkv6_pallas``: at T > 1 a chunk-parallel scan (one block per
chunk, each taking its incoming state from the chunk before), at T = 1 one
streaming pass over the state.  ``wkv6_plain`` is the same function in plain
PyTorch, chunked like the JAX package's ``ops._wkv6_jnp``: the CPU path and
the reference the kernel is held against on the card.

Both compute every decay as ``exp`` of a sum of log-decays that is ≤ 0 —
intra-chunk pairs as ``exp(Le_t − L_s)``, the state read as ``exp(Le_t)``,
the state update as ``exp(LC − L_s)`` and ``exp(LC)`` — with no clamp, and
neither takes such an exponent as a difference of two fp32 cumulative sums:
once decays reach 1e-12 a chunk's sums run to hundreds, where such a
difference loses ~1e-4 of a decay that is near 1 and moves the output that
far from the token-by-token oracle.  The kernel sums log-decays of one sign
(see its header); the plain version works in float64 from the fp32
log-decays and rounds once at the end, so it stands for the exact result
and the kernel is held to its own fp32 error.  ``wkv6_pallas``
instead factors the pair decay as ``exp(clip(Le_t)) · exp(clip(−L_s))`` with
a clip at ±30, which turns a decay below e⁻³⁰ into 1 once a chunk's
cumulative log-decay falls under −30; the port does not copy that.

Training adds the backward, which the JAX package takes as ``jax.grad`` of
``_wkv6_jnp``: ``wkv6_backward_cuda`` launches ``csrc/rwkv6_scan_bwd.cu``
(the forward's chain writing the state entering every chunk, then one
block per (chunk, head, row) in reverse ticket order carrying the state's
gradient G from chunk to chunk, then ∂u), ``wkv6_backward_plain`` is the
same recurrences token by token in float64, and :class:`WKV6` joins forward
and backward for autograd.
With G_t the gradient of the state before token t:

    ∂r_t = S_t · do_t + u ⊙ k_t (v_t · do_t)
    ∂k_t = G_{t+1} · v_t + u ⊙ r_t (v_t · do_t)
    ∂v_t = G_{t+1}ᵀ · k_t + (Σ r_t u k_t) do_t
    ∂lw_t = w_t ⊙ Σ_e G_{t+1} ⊙ S_t  (over the value axis)
    G_t = diag(w_t) G_{t+1} + r_tᵀ do_t,   ∂u = Σ r_t ⊙ k_t (v_t · do_t)

∂lw_t takes the state and its gradient of the same token, so every term
holds the factor w_t and the result keeps its relative precision where
w_t is 1e-12; a difference of two sums over tokens (r ⊙ ∂r through the
state, less k ⊙ ∂k through the state) would give ∂lw to fp32's absolute
error only, and ∂w = ∂lw / w, where w is 1e-12, errors that dwarf it.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, launches
from repro_torch.kernels.scratch import held_zeros

__all__ = ["wkv6_cuda", "wkv6_plain", "HEAD_DIMS", "CHUNK", "wkv6_backward_cuda",
           "wkv6_backward_plain", "WKV6"]

HEAD_DIMS = (16, 32, 64)                  # the kernel's compiled head widths
CHUNK = 32                                # tokens per chunk, both versions and the backward
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def wkv6_plain(r, k, v, w, u, state=None):
    """r/k/v: (B, T, H, D); w: (B, T, H, D) decays in (0, 1]; u: (H, D);
    state: (B, H, D, D) fp32 or None (zeros).  Returns ``(out (B, T, H, D)
    in r's dtype, final state (B, H, D, D) fp32)``.

    ``_wkv6_jnp`` in PyTorch, with its default chunk of ``CHUNK`` tokens:
    T is padded to a chunk multiple with ``w = 1`` and zero r/k/v, each
    chunk's pair decays are taken pairwise (every exponent ≤ 0), and the
    state carries across chunks.  The log-decays are taken in fp32, as the
    kernel takes them; everything after runs in float64, and the output is
    rounded to fp32 and then to r's dtype, the state to fp32.
    """
    B, T, H, D = r.shape
    dev = r.device
    if state is None:
        state = torch.zeros((B, H, D, D), dtype=torch.float32, device=dev)
    S = state.double()
    pad = (-T) % CHUNK
    r_, k_, v_ = (x.double() for x in (r, k, v))
    w_ = w.float()
    if pad:
        r_, k_, v_ = (F.pad(x, (0, 0, 0, 0, 0, pad)) for x in (r_, k_, v_))
        w_ = F.pad(w_, (0, 0, 0, 0, 0, pad), value=1.0)
    n, C = (T + pad) // CHUNK, CHUNK
    u64 = u.double()
    lw = torch.log(w_.clamp(1e-12, 1.0)).double()       # logs ≤ 0
    tri = torch.tril(torch.ones((C, C), dtype=torch.bool, device=dev), diagonal=-1)
    outs = []
    for c in range(n):
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc, lwc = r_[:, sl], k_[:, sl], v_[:, sl], lw[:, sl]     # (B, C, H, D)
        Lc = torch.cumsum(lwc, dim=1)                    # inclusive Σ_{j≤t} log w_j
        L_excl = Lc - lwc                                # exclusive Σ_{j<t}
        # state contribution: r_t · diag(exp(L_excl_t)) S
        o_state = torch.einsum("bchd,bhde->bche", rc * torch.exp(L_excl), S)
        # intra-chunk: pair decay exp(L_excl[t] − L[s]) for s < t (≤ 1)
        pair = L_excl[:, :, None] - Lc[:, None, :]       # (B, C, C, H, D)
        amp = torch.where(tri[None, :, :, None, None], torch.exp(pair), 0.0)
        att = torch.einsum("bthd,btshd,bshd->bths", rc, amp, kc)
        o_intra = torch.einsum("bths,bshe->bthe", att, vc)
        # current token via the bonus u: (Σ_d r_td u_d k_td) · v_t
        o_diag = torch.einsum("bchd,bchd,bche->bche", rc, u64 * kc, vc)
        outs.append(o_state + o_intra + o_diag)
        # S' = diag(exp(L_C)) S + Σ_s diag(exp(L_C − L_s)) k_sᵀ v_s
        LC = Lc[:, -1:]                                  # (B, 1, H, D)
        k_dec = kc * torch.exp(LC - Lc)
        S = torch.exp(LC[:, 0])[..., None] * S + torch.einsum("bshd,bshe->bhde", k_dec, vc)
    out = torch.cat(outs, dim=1)[:, :T]
    return out.float().to(r.dtype), S.float()


def _lib() -> ctypes.CDLL:
    lib = build.load("rwkv6_scan")
    fn = lib.repro_wkv6
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def wkv6_cuda(r, k, v, w, u, state=None):
    """Launch the CUDA WKV6 kernel.  r/k/v: (B, T, H, D) contiguous, float32
    or bfloat16; w: (B, T, H, D) contiguous float32 (a bf16 decay would move
    the result away from the reference); u: (H, D) of r's dtype; state:
    (B, H, D, D) contiguous float32, or None for zeros.  All on one CUDA
    device, D in ``HEAD_DIMS``.  Returns ``(out (B, T, H, D) in r's dtype,
    final state (B, H, D, D) float32)`` as new tensors.  Raises on anything
    else, and counts each call that launches in ``wkv6_cuda.launches``.  At
    T > 1 the call takes a scratch from the caching allocator: two fp32
    state slots a (row, head), then B·H + 1 words of flags and a counter,
    which the call zeroes on the card first."""
    B, T, H, D = r.shape
    if state is None:
        state = torch.zeros((B, H, D, D), dtype=torch.float32, device=r.device)
    named = (("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("state", state))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"wkv6_cuda: {name} is on {t.device}, not a CUDA device")
        if t.device != r.device:
            raise ValueError(f"wkv6_cuda: {name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wkv6_cuda: {name} must be contiguous, on a 16-byte boundary")
    if r.dtype not in _DTYPE_CODE or any(t.dtype != r.dtype for t in (k, v, u)):
        raise ValueError(f"wkv6_cuda: r, k, v and u must share float32 or bfloat16, got "
                         f"{r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}")
    if w.dtype != torch.float32 or state.dtype != torch.float32:
        raise ValueError(f"wkv6_cuda: w and state must be float32, got {w.dtype}, "
                         f"{state.dtype}")
    if (r.dim() != 4 or k.shape != r.shape or v.shape != r.shape or w.shape != r.shape
            or tuple(u.shape) != (H, D) or tuple(state.shape) != (B, H, D, D)):
        raise ValueError(f"wkv6_cuda: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, state "
                         f"{tuple(state.shape)} do not agree")
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6_cuda: head_dim {D} not in {HEAD_DIMS}")
    out = torch.empty_like(r)
    s_out = torch.empty_like(state)
    if B * H == 0:
        return out, s_out
    if T == 0:
        s_out.copy_(state)
        return out, s_out
    lib = _lib()
    scratch = None
    if T > 1:      # freed on return: the allocator reuses it only after this stream's work
        scratch = torch.empty(B * H * (2 * D * D + 1) + 1, dtype=torch.float32,
                              device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    err = lib.repro_wkv6(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(),
                         state.data_ptr(), out.data_ptr(), s_out.data_ptr(),
                         None if scratch is None else scratch.data_ptr(), B, T, H, D,
                         _DTYPE_CODE[r.dtype], stream)
    if err != 0:
        raise RuntimeError(f"wkv6_cuda: launch failed with CUDA error {err}")
    launches.count(wkv6_cuda)
    return out, s_out


wkv6_cuda.launches = 0


def _dw_from_dlw(dlw, w):
    """∂w from ∂(log clip(w, 1e-12, 1)), as autograd takes it through the
    clamp: ∂lw / w where 1e-12 ≤ w ≤ 1, zero elsewhere; float32."""
    wf = w.float()
    inside = (wf >= 1e-12) & (wf <= 1.0)
    return torch.where(inside, dlw / torch.where(inside, wf, 1.0), 0.0)


def wkv6_backward_plain(r, k, v, w, u, d_out, state=None, d_state=None):
    """Gradients of :func:`wkv6_plain` at (r, k, v, w, u, state) given the
    output's gradient ``d_out`` (B, T, H, D) and the final state's
    ``d_state`` (B, H, D, D) or None (zeros).  Returns ``(dr, dk, dv, dw,
    du, d_state0)``: dr/dk/dv in r's dtype, dw float32, du (H, D) in u's
    dtype, d_state0 float32 (B, H, D, D).

    The recurrences of the module docstring token by token in float64 from
    the fp32 inputs, the states kept for the reverse sweep; each result is
    rounded once.  The decays are the forward's, exp of the fp32
    log(clip(w, 1e-12, 1)).
    """
    B, T, H, D = r.shape
    dev = r.device
    S = (torch.zeros((B, H, D, D), dtype=torch.float64, device=dev) if state is None
         else state.double())
    r_, k_, v_, do = (x.double() for x in (r, k, v, d_out))
    wd = torch.exp(torch.log(w.float().clamp(1e-12, 1.0)).double())   # the forward's decays
    u64 = u.double()
    vd = (v_ * do).sum(-1)                               # (B, T, H): v_t · do_t
    states, dr = [], torch.empty_like(r_)
    for t in range(T):
        states.append(S)
        dr[:, t] = (torch.einsum("bhij,bhj->bhi", S, do[:, t])
                    + u64 * k_[:, t] * vd[:, t, :, None])
        S = wd[:, t, ..., None] * S + k_[:, t, ..., None] * v_[:, t, :, None, :]
    G = (torch.zeros((B, H, D, D), dtype=torch.float64, device=dev) if d_state is None
         else d_state.double())
    dk, dv, dlw = torch.empty_like(r_), torch.empty_like(r_), torch.empty_like(r_)
    ruk = (r_ * u64 * k_).sum(-1)                        # (B, T, H)
    for t in reversed(range(T)):
        dlw[:, t] = wd[:, t] * (G * states[t]).sum(-1)
        dk[:, t] = (torch.einsum("bhij,bhj->bhi", G, v_[:, t])
                    + u64 * r_[:, t] * vd[:, t, :, None])
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", G, k_[:, t])
                    + ruk[:, t, :, None] * do[:, t])
        G = wd[:, t, ..., None] * G + r_[:, t, ..., None] * do[:, t, :, None, :]
    du = (r_ * k_ * vd[..., None]).sum((0, 1))
    return (dr.float().to(r.dtype), dk.float().to(k.dtype), dv.float().to(v.dtype),
            _dw_from_dlw(dlw.float(), w), du.float().to(u.dtype), G.float())


def _lib_bwd() -> ctypes.CDLL:
    lib = build.load("rwkv6_scan_bwd")
    fn = lib.repro_wkv6_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 15 + [ctypes.c_int] * 5 + [ctypes.c_void_p] * 4
        fn.restype = ctypes.c_int
        if lib.repro_wkv6_bwd_chunk() != CHUNK:
            raise RuntimeError(f"rwkv6_scan_bwd: the library's chunk "
                               f"{lib.repro_wkv6_bwd_chunk()} is not CHUNK = {CHUNK}")
    return lib


def wkv6_backward_cuda(r, k, v, w, u, d_out, state=None, d_state=None):
    """Launch the CUDA WKV6 backward.  r/k/v/d_out: (B, T, H, D) contiguous
    of one dtype, float32 or bfloat16; w: (B, T, H, D) contiguous float32;
    u: (H, D) of r's dtype; state and d_state: (B, H, D, D) contiguous
    float32, or None for zeros.  All on one CUDA device, D in
    ``HEAD_DIMS``.  Returns ``(dr, dk, dv, dw, du, d_state0)`` as
    :func:`wkv6_backward_plain` does.  Raises on anything else, and counts
    each call in ``wkv6_backward_cuda.launches``.

    Up to three launches on the current stream: the forward's chain
    writing the state entering every chunk (at T > ``CHUNK``), one block
    per (chunk, head, row) carrying G back in reverse ticket order and
    writing ∂lw and each (row, chunk)'s share of ∂u, then the sum of those
    shares in a fixed order (no atomics, so two calls give the same bits).
    The chunk states (B·H·ceil(T / CHUNK)·D² floats) and G's two slots a
    (row, head) take scratch from the caching allocator; the flags and the
    ticket counter (B·H + 1 words) are held across calls, one set a device
    and stream (``scratch.held_zeros``), and left zero.  ∂w = ∂lw / w inside the
    clip, zero outside.  Shapes, dtypes and the head width are checked
    before the device, so a width the kernel does not take raises as such
    wherever the tensors lie."""
    B, T, H, D = r.shape
    named = [("r", r), ("k", k), ("v", v), ("w", w), ("u", u), ("d_out", d_out)]
    named += [(n, t) for n, t in (("state", state), ("d_state", d_state)) if t is not None]
    if r.dtype not in _DTYPE_CODE or any(t.dtype != r.dtype for t in (k, v, u, d_out)):
        raise ValueError(f"wkv6_backward_cuda: r, k, v, u and d_out must share float32 or "
                         f"bfloat16, got {r.dtype}, {k.dtype}, {v.dtype}, {u.dtype}, "
                         f"{d_out.dtype}")
    if w.dtype != torch.float32 or any(t is not None and t.dtype != torch.float32
                                       for t in (state, d_state)):
        raise ValueError("wkv6_backward_cuda: w, state and d_state must be float32")
    if (r.dim() != 4 or any(t.shape != r.shape for t in (k, v, w, d_out))
            or tuple(u.shape) != (H, D)
            or any(t is not None and tuple(t.shape) != (B, H, D, D) for t in (state, d_state))):
        raise ValueError(f"wkv6_backward_cuda: shapes r {tuple(r.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, w {tuple(w.shape)}, u {tuple(u.shape)}, d_out "
                         f"{tuple(d_out.shape)} do not agree")
    if D not in HEAD_DIMS:
        raise ValueError(f"wkv6_backward_cuda: head_dim {D} not in {HEAD_DIMS}")
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"wkv6_backward_cuda: {name} is on {t.device}, not a CUDA device")
        if t.device != r.device:
            raise ValueError(f"wkv6_backward_cuda: {name} is on {t.device}, r on {r.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"wkv6_backward_cuda: {name} must be contiguous, on a 16-byte "
                             f"boundary")
    dr, dk, dv = torch.empty_like(r), torch.empty_like(k), torch.empty_like(v)
    dlw = torch.empty_like(w)
    d_state0 = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    du = torch.zeros((H, D), dtype=torch.float32, device=r.device)
    if B * H == 0:
        return dr, dk, dv, dlw, du.to(u.dtype), d_state0
    if T == 0:
        if d_state is None:
            return dr, dk, dv, dlw, du.to(u.dtype), d_state0.zero_()
        return dr, dk, dv, dlw, du.to(u.dtype), d_state0.copy_(d_state)
    lib = _lib_bwd()
    n_chunks = -(-T // CHUNK)
    states = torch.empty(B * H * n_chunks * D * D, dtype=torch.float32, device=r.device)
    slots = torch.empty(B * H * 2 * D * D, dtype=torch.float32, device=r.device)
    du_rows = torch.empty((B, n_chunks, H, D), dtype=torch.float32, device=r.device)
    stream = torch.cuda.current_stream(r.device).cuda_stream
    sync = held_zeros("wkv6_backward_cuda: the sync scratch", r.device, stream, B * H + 1,
                      torch.int32)
    ptr = lambda t: None if t is None else t.data_ptr()    # noqa: E731
    err = lib.repro_wkv6_bwd(r.data_ptr(), k.data_ptr(), v.data_ptr(), w.data_ptr(),
                             u.data_ptr(), ptr(state), d_out.data_ptr(), ptr(d_state),
                             dr.data_ptr(), dk.data_ptr(), dv.data_ptr(), dlw.data_ptr(),
                             du_rows.data_ptr(), du.data_ptr(), d_state0.data_ptr(),
                             B, T, H, D, _DTYPE_CODE[r.dtype], states.data_ptr(),
                             slots.data_ptr(), sync.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"wkv6_backward_cuda: launch failed with CUDA error {err}")
    launches.count(wkv6_backward_cuda)
    return dr, dk, dv, _dw_from_dlw(dlw, w), du.to(u.dtype), d_state0


wkv6_backward_cuda.launches = 0


class WKV6(torch.autograd.Function):
    """The WKV6 recurrence with its gradient: forward and backward each take
    the kernel on a CUDA tensor and the plain version on a CPU one.  The
    forward saves its inputs; the backward rebuilds the states from them.
    ``ops.wkv6`` routes here only when grad is enabled and an input
    requires it, so serving never builds a node."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, state):
        fwd = wkv6_plain if r.device.type == "cpu" else wkv6_cuda
        out, s_out = fwd(r, k, v, w, u, state)
        ctx.save_for_backward(r, k, v, w, u, state)
        ctx.set_materialize_grads(False)
        return out, s_out

    @staticmethod
    def backward(ctx, d_out, d_state):
        r, k, v, w, u, state = ctx.saved_tensors
        d_out = torch.zeros_like(r) if d_out is None else d_out.contiguous()
        if d_state is not None:
            d_state = d_state.contiguous()
        bwd = wkv6_backward_plain if r.device.type == "cpu" else wkv6_backward_cuda
        dr, dk, dv, dw, du, d_state0 = bwd(r, k, v, w, u, d_out, state, d_state)
        return dr, dk, dv, dw, du, (d_state0 if state is not None else None)
