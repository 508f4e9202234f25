"""Paged decode attention: the CUDA kernel's wrapper and its plain version.

``paged_attention_cuda`` launches ``csrc/paged_attention.cu``, the port of
the JAX package's ``paged_attention_pallas``: one query token per row against
K/V pools of pages reached through a block table.  ``paged_attention_plain``
is the same function in plain PyTorch, shaped like the JAX package's
``ops._paged_jnp`` (gather the mapped pages, then the masked softmax of
``ops._decode_jnp``, here ``decode_attention_plain``): the CPU path and the
reference the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, launches
from repro_torch.kernels.decode_attention import decode_attention_plain

__all__ = ["paged_attention_cuda", "paged_attention_plain", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 192)        # the kernel's compiled head widths
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention_plain(q, k_pool, v_pool, table, lengths):
    """q: (B, 1, H, D); k_pool/v_pool: (P, ps, Hk, D); table: (B, n_cols)
    int32 page indices (>= P is an unmapped sentinel); lengths: (B,)
    -> (B, 1, H, D).

    Gathers each row's pages into a (B, n_cols * ps, Hk, D) view.  Like the
    TPU kernel, and unlike ``_paged_jnp``, it also masks the positions of
    sentinel pages, so a retired row whose table is all sentinels gives
    zeros whatever its length (``_paged_jnp`` would read the clipped page;
    the two agree wherever every page below the length is mapped, which is
    every live row the engine serves).
    """
    P, ps = k_pool.shape[0], k_pool.shape[1]
    B, n_cols = table.shape
    safe = table.long().clamp(0, P - 1)
    k = k_pool[safe].reshape(B, n_cols * ps, *k_pool.shape[2:])
    v = v_pool[safe].reshape(B, n_cols * ps, *v_pool.shape[2:])
    mapped = (table < P).repeat_interleave(ps, dim=1)
    return decode_attention_plain(q, k, v, lengths, mask=mapped)


def _lib() -> ctypes.CDLL:
    lib = build.load("paged_attention")
    fn = lib.repro_paged_attention
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


def paged_attention_cuda(q, k_pool, v_pool, table, lengths):
    """Launch the CUDA paged-decode kernel.  q: (B, 1, H, D); k_pool/v_pool:
    (P, ps, Hk, D) of q's dtype (float32 or bfloat16); table: (B, n_cols)
    int32; lengths: (B,) int32; all contiguous on one CUDA device, D in
    ``HEAD_DIMS``.  Raises on anything else, and counts each launch in
    ``paged_attention_cuda.launches``."""
    named = (("q", q), ("k_pool", k_pool), ("v_pool", v_pool), ("table", table),
             ("lengths", lengths))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"paged_attention_cuda: {name} is on {t.device}, not a CUDA device")
        if t.device != q.device:
            raise ValueError(f"paged_attention_cuda: {name} is on {t.device}, q on {q.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"paged_attention_cuda: {name} must be contiguous, on a "
                             f"16-byte boundary")
    for name, t in named[:3]:
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE or t.dim() != 4:
            raise ValueError(f"paged_attention_cuda: {name} must be 4-d float32 or bfloat16 "
                             f"of q's dtype, got {t.dtype} {tuple(t.shape)}")
    if table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise ValueError("paged_attention_cuda: table and lengths must be int32")
    B, one, H, D = q.shape
    P, ps, Hk, Dk = k_pool.shape
    if (one != 1 or v_pool.shape != k_pool.shape or Dk != D or table.dim() != 2
            or table.shape[0] != B or tuple(lengths.shape) != (B,)):
        raise ValueError(f"paged_attention_cuda: shapes q {tuple(q.shape)}, pools "
                         f"{tuple(k_pool.shape)}/{tuple(v_pool.shape)}, table "
                         f"{tuple(table.shape)}, lengths {tuple(lengths.shape)} do not agree")
    if H % Hk != 0:
        raise ValueError(f"paged_attention_cuda: {H} query heads over {Hk} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"paged_attention_cuda: head_dim {D} not in {HEAD_DIMS}")
    if P < 1 or ps < 1 or table.shape[1] < 1:
        raise ValueError("paged_attention_cuda: empty pool or table")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.repro_paged_attention(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                                    table.data_ptr(), lengths.data_ptr(), out.data_ptr(),
                                    B, H, D, P, ps, Hk, table.shape[1],
                                    _DTYPE_CODE[q.dtype], stream)
    if err != 0:
        raise RuntimeError(f"paged_attention_cuda: launch failed with CUDA error {err}")
    launches.count(paged_attention_cuda)
    return out


paged_attention_cuda.launches = 0
