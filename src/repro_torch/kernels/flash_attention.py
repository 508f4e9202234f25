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
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import build

__all__ = ["flash_attention_cuda", "flash_attention_plain", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)        # the kernel's compiled head widths
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
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
