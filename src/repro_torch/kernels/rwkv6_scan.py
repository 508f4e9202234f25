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
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

__all__ = ["wkv6_cuda", "wkv6_plain", "HEAD_DIMS", "CHUNK"]

HEAD_DIMS = (16, 32, 64)                  # the kernel's compiled head widths
CHUNK = 32                                # tokens per chunk, both versions
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
    wkv6_cuda.launches += 1
    return out, s_out


wkv6_cuda.launches = 0
