"""Flash attention for prefill: the CUDA kernels' wrapper and their plain version.

``flash_attention_cuda`` launches ``csrc/flash_attention.cu``, the port of
the JAX package's ``flash_attention_pallas`` (causal GQA with an optional
sliding window, Sq == Skv).  The dtype picks the kernel: bf16 runs
``flash_tc_kernel`` on the tensor cores (``wgmma`` over tiles that TMA
brings into 128-byte-swizzled shared memory; P is rounded to bf16 before
P·V, one bf16 unit of a row's scale), fp32 the CUDA-core kernels, whose
full-fp32 products the fp32 parity checks need.  ``flash_attention_plain``
is the same function in plain PyTorch, tiled like the JAX package's
``ops._flash_jnp``: the CPU path and the reference both kernels are held
against on the card.

Training adds the backward: ``flash_attention_backward_cuda`` launches
``csrc/flash_attention_bwd.cu`` (three kernels: the rows' log-sum-exp and
δ, then dK/dV a KV tile, then dQ a Q tile; no atomics, so its gradients are
the same bits on every launch), ``flash_attention_backward_plain`` is the
same three steps tiled in plain PyTorch, and :class:`FlashAttention` joins
the forward and the backward for autograd, each picked by the tensors'
device.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build, launches

__all__ = ["flash_attention_cuda", "flash_attention_plain", "HEAD_DIMS",
           "flash_attention_backward_cuda", "flash_attention_backward_plain",
           "HEAD_DIMS_BWD", "FlashAttention"]

HEAD_DIMS = (16, 32, 64, 128, 256)        # the kernel's compiled head widths
HEAD_DIMS_BWD = (16, 32, 64)              # the backward kernel's
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention_plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          q_block: int = 512, kv_block: int = 1024,
                          causal_skip: bool = True):
    """q: (B, Sq, H, D); k/v: (B, Skv, Hk, D) -> (B, Sq, H, D).

    Block-tiled online softmax in fp32 with ``-inf`` masking, as
    ``_flash_jnp``; sequence ends are aligned (query i sees keys
    <= i + Skv − Sq).  ``causal_skip`` restricts each query block to the KV
    blocks it can see.
    """
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    orig_sq, orig_skv = Sq, Skv
    qb = min(q_block, Sq)
    kb = min(kv_block, Skv)
    pad_q = (-Sq) % qb
    pad_k = (-Skv) % kb
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
        Sq += pad_q
    if pad_k:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_k))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_k))
        Skv += pad_k
    nq, nk = Sq // qb, Skv // kb
    offset = orig_skv - orig_sq
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    neg_inf = torch.tensor(float("-inf"), device=dev)

    outs = []
    for i in range(nq):
        qi = q[:, i * qb:(i + 1) * qb].float()
        q_pos = i * qb + torch.arange(qb, device=dev) + offset
        m = torch.full((B, qb, H), float("-inf"), device=dev)
        l = torch.zeros((B, qb, H), device=dev)
        acc = torch.zeros((B, qb, H, D), device=dev)
        lo, hi = 0, nk
        if causal and causal_skip:
            hi = min(nk, (i * qb + qb - 1 + offset) // kb + 1)
            if window is not None:
                lo = max(0, (i * qb + offset - window + 1) // kb)
            hi = max(hi, lo + 1)
        for j in range(lo, hi):
            k_pos = j * kb + torch.arange(kb, device=dev)
            kj = k[:, j * kb:(j + 1) * kb].repeat_interleave(G, dim=2).float()
            vj = v[:, j * kb:(j + 1) * kb].repeat_interleave(G, dim=2).float()
            s = torch.einsum("bqhd,bkhd->bqhk", qi, kj) * scale
            mask = (k_pos < orig_skv)[None, :].expand(qb, kb)
            if causal:
                mask = mask & (k_pos[None, :] <= q_pos[:, None])
            if window is not None:
                mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
            mask = mask[None, :, None, :]
            s = torch.where(mask, s, neg_inf)
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.where(mask, torch.exp(s - m_safe[..., None]), 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bqhk,bkhd->bqhd", p, vj)
            m = m_new
        outs.append((acc / l[..., None].clamp_min(1e-30)).to(q.dtype))
    return torch.cat(outs, dim=1)[:, :orig_sq]


def _lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_cuda(q, k, v, *, causal: bool = True, window: Optional[int] = None):
    """Launch the CUDA flash-prefill kernel.  q: (B, S, H, D); k/v:
    (B, S, Hk, D) -> (B, S, H, D), all contiguous CUDA tensors of one dtype
    (float32 or bfloat16), D in ``HEAD_DIMS``.  Raises on anything else, and
    counts each launch in ``flash_attention_cuda.launches``."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention_cuda: {name} is on {t.device}, q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"flash_attention_cuda: {name} has dtype {t.dtype}; q, k and v "
                             f"must share float32 or bfloat16")
        if t.dim() != 4 or not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"flash_attention_cuda: {name} must be a contiguous 4-d tensor "
                             f"on a 16-byte boundary")
    B, S, H, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D:
        raise ValueError(f"flash_attention_cuda: shapes q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not (B, S, H, D), (B, S, Hk, D) x2")
    Hk = k.shape[2]
    if H % Hk != 0:
        raise ValueError(f"flash_attention_cuda: {H} query heads over {Hk} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda: head_dim {D} not in {HEAD_DIMS}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_cuda: window must be >= 1, got {window}")
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_flash_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                                    B, S, H, Hk, D, _DTYPE_CODE[q.dtype], int(causal),
                                    int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_cuda: launch failed with CUDA error {err}")
    launches.count(flash_attention_cuda)
    return out


flash_attention_cuda.launches = 0


def _visible(q_pos, k_pos, n_keys, causal, window):
    """(qb, kb) mask of the keys each query sees, as the forward masks them."""
    mask = (k_pos < n_keys)[None, :].expand(q_pos.shape[0], k_pos.shape[0])
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window is not None:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def flash_attention_backward_plain(q, k, v, d_out, *, causal: bool = True,
                                   window: Optional[int] = None, q_block: int = 512,
                                   kv_block: int = 1024):
    """Gradients (dq, dk, dv) of :func:`flash_attention_plain` at (q, k, v)
    given the output's gradient ``d_out``.

    The backward kernel's three steps, tiled, in fp32: (1) each row's
    log-sum-exp over its visible keys and δ = dO·O, O the fp32 output,
    summed as Σ_j P_ij (dO_i·v_j) in the same online pass over the KV tiles
    (a bf16 output's rounding would put errors of several percent of a row's
    gradient into δ); (2) for each KV tile, over the Q tiles that see it,
    P = exp(S·scale − LSE), dP = dO·Vᵀ, dS = P∘(dP − δ), dV += Pᵀ·dO and
    dK += dSᵀ·Q·scale, the G query heads of a KV head summed; (3) for each
    Q tile, over its visible KV tiles, dQ += dS·K·scale.  Gradients in the
    inputs' dtypes.  Shapes and masks as :func:`flash_attention_plain`.
    """
    B, Sq, H, D = q.shape
    Skv, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qb, kb = min(q_block, Sq), min(kv_block, Skv)
    nq, nk = -(-Sq // qb), -(-Skv // kb)
    offset = Skv - Sq
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    # heads as (KV head, member of its group): query head h is (h // G, h % G)
    qf = q.float().reshape(B, Sq, Hk, G, D)
    dof = d_out.float().reshape(B, Sq, Hk, G, D)
    kf, vf = k.float(), v.float()

    def rows(i):
        return slice(i * qb, min((i + 1) * qb, Sq))

    def keys(j):
        return slice(j * kb, min((j + 1) * kb, Skv))

    def tiles_for_rows(i):
        """KV tiles any row of Q tile i sees."""
        r = rows(i)
        hi = min(nk, (r.stop - 1 + offset) // kb + 1) if causal else nk
        lo = max(0, (r.start + offset - window + 1) // kb) if window is not None else 0
        return range(lo, hi)

    def scores(i, j):
        r, c = rows(i), keys(j)
        s = torch.einsum("bqngd,bknd->bqngk", qf[:, r], kf[:, c]) * scale
        mask = _visible(torch.arange(r.start, r.stop, device=dev) + offset,
                        torch.arange(c.start, c.stop, device=dev), Skv, causal, window)
        return s, mask[None, :, None, None, :]

    def dscores(i, j):
        return torch.einsum("bqngd,bknd->bqngk", dof[:, rows(i)], vf[:, keys(j)])

    # 1. log-sum-exp and δ of every row, online over the KV tiles
    lse = torch.empty((B, Sq, Hk, G), device=dev)
    delta = torch.empty_like(lse)
    for i in range(nq):
        r = rows(i)
        m = torch.full((B, r.stop - r.start, Hk, G), float("-inf"), device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros_like(m)
        for j in tiles_for_rows(i):
            s, mask = scores(i, j)
            s = torch.where(mask, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            e = torch.exp(s - m_safe[..., None])
            l = l * corr + e.sum(dim=-1)
            acc = acc * corr + (e * dscores(i, j)).sum(dim=-1)
            m = m_new
        lse[:, r] = torch.where(l > 0, m + torch.log(l), float("inf"))
        delta[:, r] = torch.where(l > 0, acc / l.clamp_min(1e-30), 0.0)

    def probs_and_dscores(i, j):
        r = rows(i)
        s, mask = scores(i, j)
        p = torch.where(mask, torch.exp(s - lse[:, r, ..., None]), 0.0)
        return p, p * (dscores(i, j) - delta[:, r, ..., None])

    # 2. dK and dV, a KV tile at a time, over the Q tiles that see it
    dk = torch.zeros((B, Skv, Hk, D), device=dev)
    dv = torch.zeros_like(dk)
    for j in range(nk):
        c = keys(j)
        for i in range(nq):
            if j not in tiles_for_rows(i):
                continue
            p, ds = probs_and_dscores(i, j)
            dv[:, c] += torch.einsum("bqngk,bqngd->bknd", p, dof[:, rows(i)])
            dk[:, c] += torch.einsum("bqngk,bqngd->bknd", ds, qf[:, rows(i)]) * scale
    # 3. dQ, a Q tile at a time, over its visible KV tiles
    dq = torch.zeros_like(qf)
    for i in range(nq):
        for j in tiles_for_rows(i):
            _, ds = probs_and_dscores(i, j)
            dq[:, rows(i)] += torch.einsum("bqngk,bknd->bqngd", ds, kf[:, keys(j)]) * scale
    return (dq.reshape(B, Sq, H, D).to(q.dtype), dk.to(k.dtype), dv.to(v.dtype))


def _lib_bwd() -> ctypes.CDLL:
    lib = build.load("flash_attention_bwd")
    fn = lib.repro_flash_attention_bwd
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def flash_attention_backward_cuda(q, k, v, d_out, *, causal: bool = True,
                                  window: Optional[int] = None):
    """Launch the CUDA flash-attention backward.  q, d_out: (B, S, H, D);
    k/v: (B, S, Hk, D), all contiguous CUDA tensors of one dtype (float32 or
    bfloat16), D in ``HEAD_DIMS_BWD``.  Returns (dq, dk, dv) in that dtype.
    Raises on anything else, and counts each call (its three kernels) in
    ``flash_attention_backward_cuda.launches``."""
    for name, t in (("q", q), ("k", k), ("v", v), ("d_out", d_out)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention_backward_cuda: {name} is on {t.device}, "
                             f"not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"flash_attention_backward_cuda: {name} is on {t.device}, "
                             f"q on {q.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE:
            raise ValueError(f"flash_attention_backward_cuda: {name} has dtype {t.dtype}; "
                             f"all four must share float32 or bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"flash_attention_backward_cuda: {name} must be a contiguous "
                             f"4-d tensor")
    B, S, H, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[1] != S or k.shape[3] != D
            or d_out.shape != q.shape):
        raise ValueError(f"flash_attention_backward_cuda: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, d_out {tuple(d_out.shape)} "
                         f"are not (B, S, H, D), (B, S, Hk, D) x2, (B, S, H, D)")
    Hk = k.shape[2]
    if H % Hk != 0:
        raise ValueError(f"flash_attention_backward_cuda: {H} query heads over {Hk} KV heads")
    if D not in HEAD_DIMS_BWD:
        raise ValueError(f"flash_attention_backward_cuda: head_dim {D} not in {HEAD_DIMS_BWD}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_backward_cuda: window must be >= 1, got {window}")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    if q.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    lib = _lib_bwd()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_flash_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(), dq.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        B, S, H, Hk, D, _DTYPE_CODE[q.dtype], int(causal), int(window or 0), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_backward_cuda: launch failed with CUDA error {err}")
    launches.count(flash_attention_backward_cuda)
    return dq, dk, dv


flash_attention_backward_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """Flash attention with its gradient: the forward and the backward each
    take the kernel on a CUDA tensor and the plain version on a CPU one.
    The forward saves q, k and v; the backward recomputes the probabilities
    from them.  ``ops.flash_attention`` routes here only when
    grad is enabled and an input requires it, so serving never builds a
    node."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block, causal_skip):
        if q.device.type == "cpu":
            out = flash_attention_plain(q, k, v, causal=causal, window=window,
                                        q_block=q_block, kv_block=kv_block,
                                        causal_skip=causal_skip)
        else:
            out = flash_attention_cuda(q, k, v, causal=causal, window=window)
        ctx.save_for_backward(q, k, v)
        ctx.causal, ctx.window = causal, window
        ctx.q_block, ctx.kv_block = q_block, kv_block
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        d_out = d_out.contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_attention_backward_plain(
                q, k, v, d_out, causal=ctx.causal, window=ctx.window,
                q_block=ctx.q_block, kv_block=ctx.kv_block)
        else:
            dq, dk, dv = flash_attention_backward_cuda(q, k, v, d_out,
                                                       causal=ctx.causal, window=ctx.window)
        return dq, dk, dv, None, None, None, None, None
