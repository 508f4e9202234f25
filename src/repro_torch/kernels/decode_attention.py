"""Decode attention against a contiguous KV cache: the CUDA kernel's wrapper
and its plain version.

``decode_attention_cuda`` launches ``csrc/decode_attention.cu``, the port of
the JAX package's ``decode_attention_pallas``: one query token per row
against a ``(B, Smax, Hk, D)`` cache, keys ``< lengths[b]`` visible.  The
kernel takes the cache's batch and sequence strides, so a horizon slice
``cache[:, :horizon]`` of a longer buffer is read in place, never copied.
At head widths 128 and 256 the kernel splits the sequence into pieces of
at least two 16-position tiles, one block each, multiplies on the tensor
cores in bf16, and merges the pieces' partial softmaxes in the same launch
("flash-decoding"): the blocks of each cluster of 8 pieces merge their
partials through shared memory, and the last cluster to finish merges the
row, a column slice a block.  Their fp32 scratch and counters are
held here across calls, one a (device, layout); the kernel leaves the
counters zeroed.  ``decode_attention_plain`` is the same function in
plain PyTorch, shaped
like the JAX package's ``ops._decode_jnp``: the CPU path and the reference
the kernel is held against on the card.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, launches

__all__ = ["decode_attention_cuda", "decode_attention_plain", "HEAD_DIMS"]

HEAD_DIMS = (16, 32, 64, 128, 256)        # the kernel's compiled head widths
SPLIT_DIMS = (128, 256)                   # widths that split the sequence over blocks
# the wide-head kernel's tiling (csrc/decode_attention.cu): positions a tile,
# pieces a row at most, pieces a cluster (a first-level merge), query heads a slice
WIDE_TILE, WIDE_MAX_PIECES, WIDE_GROUP, WIDE_HEADS = 16, 64, 8, 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_scratch: dict[tuple, torch.Tensor] = {}


def wide_piece_len(S):
    """Positions a piece of the wide-head kernel takes: at least two tiles,
    more where ``S`` would need over ``WIDE_MAX_PIECES`` pieces."""
    return max(2, -(-(-(-S // WIDE_TILE)) // WIDE_MAX_PIECES)) * WIDE_TILE


def wide_pieces(S):
    """Pieces the wide-head kernel splits a cache of ``S`` positions into: a
    multiple of ``WIDE_GROUP`` (a cluster's), the ones past ``S`` empty."""
    n = max(1, -(-S // wide_piece_len(S)))
    return -(-n // WIDE_GROUP) * WIDE_GROUP


def _wide_scratch(device, R, P, D):
    """The wide-head kernel's scratch for R (row, KV head, slice) triples of
    P pieces at head width D: the clusters' partials (acc, then (m, l) once a
    column slice), then R · ``WIDE_GROUP`` counters, all zero when made; held
    across calls, since every launch leaves the counters zero.  A CUDA graph
    bakes the scratch's address in, so a new shape must come by eagerly
    first: allocating it while the stream is captured raises."""
    key = (device, R, P, D)
    buf = _scratch.get(key)
    if buf is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"decode_attention_cuda: no held scratch for {key} while the "
                               f"stream is captured; run this shape once eagerly before "
                               f"capturing it")
        n_grp = P // WIDE_GROUP
        n = R * n_grp * WIDE_HEADS * (D + 2 * WIDE_GROUP) + R * WIDE_GROUP
        buf = _scratch[key] = torch.zeros(n, dtype=torch.float32, device=device)
    return buf


def decode_attention_plain(q, k, v, lengths, mask=None):
    """q: (B, 1, H, D); k/v: (B, Smax, Hk, D); lengths: (B,) -> (B, 1, H, D).

    Explicit max/exp/sum softmax in fp32 over the keys ``< lengths``, as
    ``_decode_jnp``; ``mask`` (B, Smax), when given, further restricts the
    keys a row may see.  A row with no visible key gives zeros.
    """
    B, _, H, D = q.shape
    Hk = k.shape[2]
    G = H // Hk
    scale = 1.0 / math.sqrt(D)
    qg = q[:, 0].float().reshape(B, Hk, G, D)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, k.float()) * scale
    valid = torch.arange(k.shape[1], device=q.device)[None, :] < lengths[:, None]
    if mask is not None:
        valid = valid & mask
    valid = valid[:, None, None, :]
    s = torch.where(valid, s, float("-inf"))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(s - m), 0.0)
    num = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    den = p.sum(dim=-1, keepdim=True)
    return (num / den.clamp_min(1e-30)).reshape(B, 1, H, D).to(q.dtype)


def _lib() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    fn = lib.repro_decode_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_longlong] * 2 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        split = lib.repro_decode_attention_split
        split.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 6
                          + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
        split.restype = ctypes.c_int
    return lib


def decode_attention_cuda(q, k, v, lengths):
    """Launch the CUDA decode-attention kernel.  q: (B, 1, H, D) contiguous;
    k/v: (B, Smax, Hk, D) of q's dtype (float32 or bfloat16) with unit
    element stride and head stride D, sharing their batch and sequence
    strides (a horizon slice of a longer cache qualifies); lengths: (B,)
    int32, clipped to Smax by the kernel.  All on one CUDA device, D in
    ``HEAD_DIMS``.  Raises on anything else, and counts each launch in
    ``decode_attention_cuda.launches``.  At D in ``SPLIT_DIMS`` the launch
    uses a held scratch (``_wide_scratch``), so calls on one device run in
    stream order."""
    named = (("q", q), ("k", k), ("v", v), ("lengths", lengths))
    for name, t in named:
        if t.device.type != "cuda":
            raise ValueError(f"decode_attention_cuda: {name} is on {t.device}, not a CUDA "
                             f"device")
        if t.device != q.device:
            raise ValueError(f"decode_attention_cuda: {name} is on {t.device}, q on {q.device}")
    for name, t in named[:3]:
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODE or t.dim() != 4:
            raise ValueError(f"decode_attention_cuda: {name} must be 4-d float32 or bfloat16 "
                             f"of q's dtype, got {t.dtype} {tuple(t.shape)}")
    if lengths.dtype != torch.int32 or not lengths.is_contiguous():
        raise ValueError("decode_attention_cuda: lengths must be contiguous int32")
    B, one, H, D = q.shape
    _, S, Hk, Dk = k.shape
    if (one != 1 or v.shape != k.shape or k.shape[0] != B or Dk != D
            or tuple(lengths.shape) != (B,)):
        raise ValueError(f"decode_attention_cuda: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}, lengths "
                         f"{tuple(lengths.shape)} do not agree")
    if H % Hk != 0:
        raise ValueError(f"decode_attention_cuda: {H} query heads over {Hk} KV heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention_cuda: head_dim {D} not in {HEAD_DIMS}")
    vec = 16 // q.element_size()                # elements per 16-byte load
    if not q.is_contiguous() or q.data_ptr() % 16:
        raise ValueError("decode_attention_cuda: q must be contiguous, on a 16-byte boundary")
    if k.stride() != v.stride():
        raise ValueError(f"decode_attention_cuda: k and v strides differ: {k.stride()} vs "
                         f"{v.stride()}")
    bs, ss, hs, es = k.stride()
    if (es != 1 or hs != D or bs % vec or ss % vec
            or k.data_ptr() % 16 or v.data_ptr() % 16):
        raise ValueError(f"decode_attention_cuda: k/v strides {k.stride()} need unit element "
                         f"stride, head stride {D}, batch and sequence strides in multiples "
                         f"of {vec}, and 16-byte aligned data")
    out = torch.empty_like(q)
    if B == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if D in SPLIT_DIMS:
        n_pieces = wide_pieces(S)
        R = B * Hk * -(-(H // Hk) // WIDE_HEADS)
        scratch = _wide_scratch(q.device, R, n_pieces, D)
        err = lib.repro_decode_attention_split(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
            scratch.data_ptr(), B, H, Hk, D, S, _DTYPE_CODE[q.dtype], bs, ss, n_pieces, stream)
    else:
        err = lib.repro_decode_attention(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                                         lengths.data_ptr(), out.data_ptr(), B, H, Hk, D, S,
                                         _DTYPE_CODE[q.dtype], bs, ss, stream)
    if err != 0:
        raise RuntimeError(f"decode_attention_cuda: launch failed with CUDA error {err}")
    launches.count(decode_attention_cuda)
    return out


decode_attention_cuda.launches = 0
