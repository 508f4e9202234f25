"""The port's kernels on the CPU: their plain PyTorch versions held against
the JAX package's tiled versions, its naive oracles and its Pallas kernels
(interpret mode), and the device dispatch of the wrappers.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against its plain version there.  Attention tolerances are those of
``tests/test_kernels.py``: 2e-5 in float32 (summation order differs between
the frameworks), 2e-2 in bfloat16 (one bf16 rounding of the output).  WKV6
is held to 2e-4 in float32, as the JAX package's kernel tests hold it: its
outputs run to tens, and the chunked and token-by-token forms round
differently.
"""
import math
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro.kernels.rwkv6_scan import wkv6_pallas
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.decode_attention import decode_attention_cuda, decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain
from repro_torch.kernels.rwkv6_scan import wkv6_cuda, wkv6_plain


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _arrs(rng, dtype, *shapes):
    """The same numpy draws as a torch tensor and a jax array each, already
    rounded to ``dtype`` so both frameworks see identical inputs."""
    out = []
    for shape in shapes:
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(TORCH[dtype])
        out.append((t, jnp.asarray(t.float().numpy(), JNP[dtype])))
    return out


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=TOL[dtype], rtol=TOL[dtype])


# ---------------------------------------------------------------------------
# flash attention (prefill)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Hk,D,causal,win,qb,kb", [
    (2, 128, 4, 2, 32, True, None, 32, 32),
    (1, 64, 8, 8, 16, True, 16, 16, 16),
    (2, 96, 4, 1, 32, True, None, 32, 16),     # MQA, uneven blocks
    (1, 128, 2, 2, 64, False, None, 64, 32),   # bidirectional
])
def test_flash_plain_matches_jax(dtype, B, S, H, Hk, D, causal, win, qb, kb):
    rng = np.random.default_rng(S + H + D)
    (q, jq), (k, jk), (v, jv) = _arrs(rng, dtype, (B, S, H, D), (B, S, Hk, D), (B, S, Hk, D))
    got = flash_attention_plain(q, k, v, causal=causal, window=win, q_block=qb, kv_block=kb)
    assert got.dtype == q.dtype and got.shape == q.shape
    want_jnp = jops._flash_jnp(jq, jk, jv, causal=causal, window=win, q_block=qb,
                               kv_block=kb, causal_skip=True)
    want_pallas = flash_attention_pallas(jq, jk, jv, causal=causal, window=win, q_block=qb,
                                         kv_block=kb, interpret=True)
    _close(got, want_jnp, dtype)
    _close(got, want_pallas, dtype)


def test_flash_plain_padding_and_offset_match_jax():
    """Ragged sequence (tiles padded) and, as in the JAX fallback, a query
    block aligned to the end of a longer key sequence."""
    rng = np.random.default_rng(7)
    (q, jq), (k, jk), (v, jv) = _arrs(rng, "float32", (2, 17, 4, 8), (2, 33, 2, 8),
                                      (2, 33, 2, 8))
    got = flash_attention_plain(q, k, v, causal=True, q_block=8, kv_block=8)
    _close(got, jref.mha_ref(jq, jk, jv, causal=True), "float32")
    _close(got, jops._flash_jnp(jq, jk, jv, causal=True, window=None, q_block=8, kv_block=8,
                                causal_skip=True), "float32")


@pytest.mark.parametrize("causal,win", [(True, None), (True, 5), (False, None)])
def test_torch_oracle_matches_jax_oracle(causal, win):
    rng = np.random.default_rng(3)
    (q, jq), (k, jk), (v, jv) = _arrs(rng, "float32", (2, 20, 4, 16), (2, 20, 2, 16),
                                      (2, 20, 2, 16))
    _close(ref.mha_ref(q, k, v, causal=causal, window=win),
           jref.mha_ref(jq, jk, jv, causal=causal, window=win), "float32")
    lengths = np.asarray([3, 20], np.int32)
    _close(ref.decode_attention_ref(q[:, :1], k, v, torch.from_numpy(lengths)),
           jref.decode_attention_ref(jq[:, :1], jk, jv, jnp.asarray(lengths)), "float32")


def _flash_with_bf16_probabilities(q, k, v, *, window=None, kv_tile=64):
    """Causal attention in fp32 with an online softmax over tiles of
    ``kv_tile`` keys in the log2 domain, each tile's unnormalised
    probabilities rounded to bf16 before P·V while the row sums take them in
    fp32, the output rounded to bf16: the arithmetic of the bf16
    tensor-core kernel, written out in PyTorch."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf = q.float()
    kf, vf = (x.float().repeat_interleave(G, dim=2) for x in (k, v))
    scale = math.log2(math.e) / math.sqrt(D)
    pos = torch.arange(S)
    m = torch.full((B, S, H), -1e30)
    l = torch.zeros(B, S, H)
    acc = torch.zeros(B, S, H, D)
    for k0 in range(0, S, kv_tile):
        kp = pos[k0:k0 + kv_tile]
        ok = kp[None, :] <= pos[:, None]
        if window is not None:
            ok = ok & (kp[None, :] > pos[:, None] - window)
        ok = ok[None, :, None, :]
        s = torch.einsum("bqhd,bkhd->bqhk", qf, kf[:, k0:k0 + kv_tile]) * scale
        s = torch.where(ok, s, -1e30)
        m_new = torch.maximum(m, s.amax(dim=-1))
        corr = torch.exp2(m - m_new)
        p = torch.where(ok, torch.exp2(s - m_new[..., None]), 0.0)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bqhk,bkhd->bqhd", p.to(torch.bfloat16).float(), vf[:, k0:k0 + kv_tile])
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(torch.bfloat16)


@pytest.mark.parametrize("B,S,H,Hk,D,window", [
    (1, 150, 16, 1, 256, 64),     # MQA at head width 256 with a window, as RecurrentGemma
    (2, 130, 4, 4, 64, None),     # causal at head width 64, as the serving prefill
])
def test_bf16_probabilities_stay_within_the_cards_check(B, S, H, Hk, D, window):
    """Models the rounding the bf16 flash kernel adds (P rounded to bf16
    before P·V, which its tensor-core product needs) and holds it against
    ``flash_attention_plain`` at the card's bf16 check: each output row's
    max error over the row's max |plain| within 2e-2.  It is no test of the
    kernel, which runs only on the card; ``chip_smoke.py`` holds the kernel
    itself to the same check there."""
    rng = np.random.default_rng(S + D)
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch.bfloat16)
               for shape in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D)))
    got = _flash_with_bf16_probabilities(q, k, v, window=window)
    want = flash_attention_plain(q, k, v, window=window)
    err = (got.float() - want.float()).abs().amax(dim=-1)
    rel = (err / want.float().abs().amax(dim=-1).clamp(min=1e-6)).max().item()
    assert rel <= TOL["bfloat16"]
    assert not torch.equal(got, want)     # the rounding shows: this models something


# ---------------------------------------------------------------------------
# decode attention against a contiguous cache
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,Smax,H,Hk,D", [
    (4, 40, 8, 2, 16),
    (3, 130, 4, 4, 32),
    (2, 64, 8, 1, 64),
])
def test_decode_plain_matches_jax(dtype, B, Smax, H, Hk, D):
    """Ragged lengths with one empty row (zeros) and one full row, against
    ``_decode_jnp`` and the Pallas kernel (interpret mode, kv_block 32 so
    the online softmax crosses blocks)."""
    rng = np.random.default_rng(B * Smax + D)
    (q, jq), (k, jk), (v, jv) = _arrs(rng, dtype, (B, 1, H, D), (B, Smax, Hk, D),
                                      (B, Smax, Hk, D))
    lengths = rng.integers(1, Smax + 1, B).astype(np.int32)
    lengths[0], lengths[-1] = 0, Smax
    got = decode_attention_plain(q, k, v, torch.from_numpy(lengths))
    assert got.dtype == q.dtype and got.shape == q.shape
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    _close(got, jops._decode_jnp(jq, jk, jv, jnp.asarray(lengths)), dtype)
    _close(got, decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths), kv_block=32,
                                        interpret=True), dtype)


def test_decode_plain_on_a_horizon_view():
    """The engine's decode reads a horizon slice ``cache[:, :h]`` of a longer
    buffer in place: the plain version on the strided view gives what the
    JAX versions give on the sliced copy, and the oracle agrees."""
    rng = np.random.default_rng(13)
    B, max_len, horizon, H, Hk, D = 3, 96, 48, 4, 2, 16
    (q, jq), (kf, _), (vf, _) = _arrs(rng, "float32", (B, 1, H, D), (B, max_len, Hk, D),
                                      (B, max_len, Hk, D))
    k, v = kf[:, :horizon], vf[:, :horizon]
    assert not k.is_contiguous() and k.stride(0) == max_len * Hk * D
    lengths = np.asarray([horizon, 17, 1], np.int32)
    jk, jv = jnp.asarray(k.numpy()), jnp.asarray(v.numpy())
    got = ops.decode_attention(q, k, v, torch.from_numpy(lengths))
    _close(got, jops._decode_jnp(jq, jk, jv, jnp.asarray(lengths)), "float32")
    _close(got, decode_attention_pallas(jq, jk, jv, jnp.asarray(lengths), kv_block=16,
                                        interpret=True), "float32")
    _close(got, jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths)), "float32")
    _close(ref.decode_attention_ref(q, k, v, torch.from_numpy(lengths)),
           jref.decode_attention_ref(jq, jk, jv, jnp.asarray(lengths)), "float32")


# ---------------------------------------------------------------------------
# RWKV6 WKV recurrence
# ---------------------------------------------------------------------------

WKV_TOL = 2e-4


def _wkv_inputs(rng, B, T, H, D, decay):
    """r/k/v ~ N(0, 1), u ~ U(−0.5, 0.5), a carried state, and decays in the
    ``mild`` range U(0.4, 0.999) of ``tests/test_kernels.py`` or the
    ``strong`` one U(0.15, 0.3), whose cumulative log-decay passes −30
    within a chunk of 32."""
    r, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    lo, hi = {"mild": (0.4, 0.999), "strong": (0.15, 0.3)}[decay]
    w = rng.uniform(lo, hi, (B, T, H, D)).astype(np.float32)
    u = rng.uniform(-0.5, 0.5, (H, D)).astype(np.float32)
    s0 = (0.3 * rng.normal(size=(B, H, D, D))).astype(np.float32)
    return r, k, v, w, u, s0


def _wkv_close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=WKV_TOL,
                               rtol=WKV_TOL)


@pytest.mark.parametrize("decay", ["mild", "strong"])
@pytest.mark.parametrize("T", [1, 33, 64])
def test_wkv6_plain_matches_jax_and_oracle(T, decay):
    rng = np.random.default_rng(T + len(decay))
    arrs = _wkv_inputs(rng, 2, T, 2, 16, decay)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in arrs)
    out, s_t = wkv6_plain(r, k, v, w, u, s0)
    assert out.dtype == torch.float32 and s_t.dtype == torch.float32
    j = [jnp.asarray(a) for a in arrs]
    want_out, want_s = jops._wkv6_jnp(*j, 32)
    _wkv_close(out, want_out)
    _wkv_close(s_t, want_s)
    ref_out, ref_s = jref.wkv6_ref(*j)
    _wkv_close(out, ref_out)
    _wkv_close(s_t, ref_s)
    # the port's own oracle is the JAX oracle
    mine_out, mine_s = ref.wkv6_ref(r, k, v, w, u, s0)
    _wkv_close(mine_out, ref_out)
    _wkv_close(mine_s, ref_s)


def test_wkv6_plain_bfloat16_rounds_the_output_only():
    """bf16 r/k/v/u with fp32 w and state: the output is the fp32 result
    rounded once to bf16, the state stays fp32."""
    rng = np.random.default_rng(21)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _wkv_inputs(rng, 1, 37, 2, 16, "mild"))
    rb, kb, vb, ub = (x.to(torch.bfloat16) for x in (r, k, v, u))
    out, s_t = wkv6_plain(rb, kb, vb, w, ub, s0)
    want, want_s = wkv6_plain(rb.float(), kb.float(), vb.float(), w, ub.float(), s0)
    assert out.dtype == torch.bfloat16 and s_t.dtype == torch.float32
    assert torch.equal(out, want.to(torch.bfloat16))
    assert torch.equal(s_t, want_s)


@pytest.mark.parametrize("T", [1, 33, 64])
def test_wkv6_plain_matches_pallas_in_the_mild_range(T):
    """Where the TPU kernel's ±30 clip never engages, it agrees too."""
    rng = np.random.default_rng(30 + T)
    arrs = _wkv_inputs(rng, 2, T, 2, 16, "mild")
    out, s_t = wkv6_plain(*(torch.from_numpy(a) for a in arrs))
    want_out, want_s = wkv6_pallas(*(jnp.asarray(a) for a in arrs), chunk=32, interpret=True)
    _wkv_close(out, want_out)
    _wkv_close(s_t, want_s)


def test_wkv6_pallas_clip_fault_is_pinned():
    """The reference's fault, pinned: at w ~ U(0.15, 0.3) with chunk 32 the
    cumulative log-decay of a chunk falls below −30, where ``wkv6_pallas``'s
    clipped factors give a pair decay of 1 instead of exp(Le_t − L_s): it is
    off the token-by-token oracle by more than 1.0, while the port's plain
    version stays within 2e-4.  Should the reference be repaired, this test
    fails and the note on the fault in ROADMAP.md §3 goes."""
    rng = np.random.default_rng(0)
    r, k, v, w, u, _ = _wkv_inputs(rng, 1, 64, 2, 16, "strong")
    j = [jnp.asarray(a) for a in (r, k, v, w, u)]
    want, _ = jref.wkv6_ref(*j)
    pallas, _ = wkv6_pallas(*j, chunk=32, interpret=True)
    assert float(jnp.abs(pallas - want).max()) > 1.0
    got, _ = wkv6_plain(*(torch.from_numpy(a) for a in (r, k, v, w, u)))
    _wkv_close(got, want)


# ---------------------------------------------------------------------------
# paged decode attention
# ---------------------------------------------------------------------------

def _paginate(rng, k, v, page_size, lengths, n_extra=3):
    """Scatter contiguous (B, S, Hk, D) K/V into a shuffled page pool whose
    unreferenced pages and tails hold large garbage; table entries for pages
    wholly past a row's length are the sentinel P (as ``tests/test_kernels``)."""
    B, S, Hk, D = k.shape
    n_tab = -(-S // page_size)
    kp = np.full((B, n_tab * page_size, Hk, D), 1e3, np.float32)
    vp = np.full_like(kp, 1e3)
    kp[:, :S] = k.float().numpy()
    vp[:, :S] = v.float().numpy()
    P = B * n_tab + n_extra
    phys = rng.permutation(P)[: B * n_tab].reshape(B, n_tab)
    k_pool = np.full((P, page_size, Hk, D), 1e3, np.float32)
    v_pool = np.full_like(k_pool, 1e3)
    k_pool[phys.reshape(-1)] = kp.reshape(B * n_tab, page_size, Hk, D)
    v_pool[phys.reshape(-1)] = vp.reshape(B * n_tab, page_size, Hk, D)
    table = np.where(np.arange(n_tab)[None] * page_size < lengths[:, None], phys, P)
    return k_pool, v_pool, table.astype(np.int32)


def _both(a, dtype):
    t = torch.from_numpy(np.asarray(a, np.float32)).to(TORCH[dtype])
    return t, jnp.asarray(t.float().numpy(), JNP[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("page_size", [16, 64])
@pytest.mark.parametrize("B,S,H,Hk,D", [
    (3, 40, 8, 2, 16),
    (2, 130, 4, 4, 32),
    (1, 64, 8, 1, 64),
])
def test_paged_plain_matches_pallas(dtype, page_size, B, S, H, Hk, D):
    rng = np.random.default_rng(B * S + page_size)
    (q, jq), (k, _), (v, _) = _arrs(rng, dtype, (B, 1, H, D), (B, S, Hk, D), (B, S, Hk, D))
    lengths = np.append(rng.integers(1, S + 1, B - 1), S).astype(np.int32)
    k_pool, v_pool, table = _paginate(rng, k, v, page_size, lengths)
    (kp, jkp), (vp, jvp) = _both(k_pool, dtype), _both(v_pool, dtype)
    got = paged_attention_plain(q, kp, vp, torch.from_numpy(table), torch.from_numpy(lengths))
    want = paged_attention_pallas(jq, jkp, jvp, jnp.asarray(table), jnp.asarray(lengths),
                                  interpret=True)
    _close(got, want, dtype)
    _close(got, jops._paged_jnp(jq, jkp, jvp, jnp.asarray(table), jnp.asarray(lengths)), dtype)


def test_paged_plain_shared_forked_and_retired_rows():
    """Rows 0 and 1 alias the same physical prefix pages and row 1's tail
    page is a CoW fork (as ``tests/test_kernels.py``); row 2 is a retired
    slot — all-sentinel table, non-zero stale length — which must give
    finite zeros, as the TPU kernel does."""
    rng = np.random.default_rng(11)
    ps, H, Hk, D = 16, 4, 2, 16
    S = 3 * ps
    pre_k, pre_v = rng.normal(size=(2, 2 * ps, Hk, D)).astype(np.float32)
    tails = rng.normal(size=(2, 2, ps, Hk, D)).astype(np.float32)   # (row, k|v, ...)
    junk = np.full((1, ps, Hk, D), 1e3, np.float32)
    k_pool = np.concatenate([pre_k.reshape(2, ps, Hk, D), tails[0, 0:1], tails[1, 0:1], junk])
    v_pool = np.concatenate([pre_v.reshape(2, ps, Hk, D), tails[0, 1:2], tails[1, 1:2], junk])
    P = k_pool.shape[0]
    table = np.asarray([[0, 1, 2], [0, 1, 3], [P, P, P]], np.int32)
    lengths = np.asarray([S, S - 5, 37], np.int32)          # row 1 mid-page
    (q, jq), = _arrs(rng, "float32", (3, 1, H, D))
    (kp, jkp), (vp, jvp) = _both(k_pool, "float32"), _both(v_pool, "float32")
    got = paged_attention_plain(q, kp, vp, torch.from_numpy(table), torch.from_numpy(lengths))
    want = paged_attention_pallas(jq, jkp, jvp, jnp.asarray(table), jnp.asarray(lengths),
                                  interpret=True)
    _close(got, want, "float32")
    assert torch.isfinite(got).all()
    assert torch.equal(got[2], torch.zeros_like(got[2]))
    assert np.array_equal(np.asarray(want)[2], np.zeros((1, H, D), np.float32))
    # the live rows each match the dense oracle on their own logical sequence
    dense_k = np.stack([np.concatenate([pre_k, tails[r, 0]]) for r in range(2)])
    dense_v = np.stack([np.concatenate([pre_v, tails[r, 1]]) for r in range(2)])
    _close(got[:2], jref.decode_attention_ref(jq[:2], jnp.asarray(dense_k),
                                              jnp.asarray(dense_v),
                                              jnp.asarray(lengths[:2])), "float32")


# ---------------------------------------------------------------------------
# the split arithmetic of the D <= 64 decode kernels (csrc/decode_body.cuh)
# ---------------------------------------------------------------------------

NEG_INF = -1e30        # the TPU kernels' finite mask value
N_WARPS, SUB = 8, 4    # warps a block; positions a warp sub-tile (small, so rows cross several)


def _split_decode(q, k, v, lengths, mapped=None):
    """The D <= 64 decode kernels' arithmetic in plain fp32 PyTorch: row b's
    n_b = min(lengths[b], S) positions split into N_WARPS contiguous ranges
    of ceil(n_b / N_WARPS); each range runs its own online softmax over
    sub-tiles of SUB positions (a position not ``mapped`` scores NEG_INF and
    weighs 0), so an empty range is (NEG_INF, 0, 0); the partials merge by
    rescaling to the largest m, and a row with nothing to read gives
    0 / max(0, 1e-30) = 0.

    q: (B, 1, H, D); k/v: (B, S, Hk, D); lengths: (B,); mapped: (B, S) bool
    or None (all).  It models the algorithm, not the kernel: only
    ``chip_smoke.py`` holds the kernel."""
    B, _, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    qg = q[:, 0].float().reshape(B, Hk, G, D)
    out = torch.zeros(B, Hk, G, D)
    for b in range(B):
        n = max(0, min(int(lengths[b]), S))
        per = -(-n // N_WARPS)
        parts = []
        for w in range(N_WARPS):
            m = torch.full((Hk, G), NEG_INF)
            l = torch.zeros(Hk, G)
            acc = torch.zeros(Hk, G, D)
            lo, hi = min(n, w * per), min(n, (w + 1) * per)
            for base in range(lo, hi, SUB):
                pos = torch.arange(base, min(base + SUB, hi))
                live = torch.ones(len(pos), dtype=torch.bool) if mapped is None \
                    else mapped[b, pos]
                s = torch.einsum("hgd,thd->hgt", qg[b], k[b, pos].float()) / math.sqrt(D)
                s = torch.where(live, s, torch.tensor(NEG_INF))
                m_new = torch.maximum(m, s.amax(dim=-1))
                c = torch.exp(m - m_new)
                p = torch.where(live, torch.exp(s - m_new[..., None]), torch.tensor(0.0))
                l = l * c + p.sum(dim=-1)
                acc = acc * c[..., None] + torch.einsum("hgt,thd->hgd", p, v[b, pos].float())
                m = m_new
            parts.append((m, l, acc))
        m_all = torch.stack([m for m, _, _ in parts])                        # (W, Hk, G)
        mx = m_all.amax(dim=0)
        c = torch.exp(m_all - mx)
        l_sum = sum(c[w] * parts[w][1] for w in range(N_WARPS))
        a_sum = sum(c[w][..., None] * parts[w][2] for w in range(N_WARPS))
        out[b] = a_sum / l_sum.clamp_min(1e-30)[..., None]
    return out.reshape(B, 1, H, D)


# lengths at the split's edges for N_WARPS and SUB, on a cache of S = 72
# positions in pages of 8: 0, 1 and page - 1; warps left empty (N_WARPS ± 1);
# one and two sub-tiles a warp ± 1; exactly S and past it
_SPLIT_S, _SPLIT_PS = 72, 8
_SPLIT_LENGTHS = {
    "short": [0, 1, _SPLIT_PS - 1],
    "warps": [N_WARPS - 1, N_WARPS, N_WARPS + 1],
    "one-sub-tile": [N_WARPS * SUB - 1, N_WARPS * SUB, N_WARPS * SUB + 1],
    "two-sub-tiles": [2 * N_WARPS * SUB - 1, 2 * N_WARPS * SUB, 2 * N_WARPS * SUB + 1],
    "capacity": [_SPLIT_S, _SPLIT_S + 5],
}


@pytest.mark.parametrize("retired", [False, True])
@pytest.mark.parametrize("G", [1, 4, 16])
@pytest.mark.parametrize("group", list(_SPLIT_LENGTHS))
def test_split_decode_arithmetic_matches_plain_jax_and_pallas(group, G, retired):
    """The warp split with empty ranges as (NEG_INF, 0, 0) gives what the
    plain versions, ``_decode_jnp`` and the Pallas paged kernel (interpret
    mode) give, at the split's edge lengths; a retired row (all-sentinel
    table, stale length) gives zeros through the page mask."""
    Hk, D = (2 if G < 16 else 1), 16
    lengths = list(_SPLIT_LENGTHS[group]) + ([40] if retired else [])
    B, H = len(lengths), G * Hk
    rng = np.random.default_rng(7 * G + len(group) + retired)
    (q, jq), (k, jk), (v, jv) = _arrs(rng, "float32", (B, 1, H, D), (B, _SPLIT_S, Hk, D),
                                      (B, _SPLIT_S, Hk, D))
    lens = np.asarray(lengths, np.int32)

    # contiguous cache: against the plain version and _decode_jnp
    got = _split_decode(q, k, v, lens)
    _close(got, decode_attention_plain(q, k, v, torch.from_numpy(lens)), "float32")
    _close(got, jops._decode_jnp(jq, jk, jv, jnp.asarray(lens)), "float32")
    assert torch.equal(got[lens == 0], torch.zeros_like(got[lens == 0]))

    # the same rows through a shuffled page pool; the retired row's table is
    # all sentinels, so it sees nothing whatever its length
    k_pool, v_pool, table = _paginate(rng, k, v, _SPLIT_PS, lens)
    if retired:
        table[-1] = k_pool.shape[0]
    mapped = torch.from_numpy(table < k_pool.shape[0]).repeat_interleave(_SPLIT_PS, dim=1)
    got = _split_decode(q, k, v, lens, mapped)
    (kp, jkp), (vp, jvp) = _both(k_pool, "float32"), _both(v_pool, "float32")
    tab, tlen = torch.from_numpy(table), torch.from_numpy(lens)
    _close(got, paged_attention_plain(q, kp, vp, tab, tlen), "float32")
    _close(got, paged_attention_pallas(jq, jkp, jvp, jnp.asarray(table), jnp.asarray(lens),
                                       interpret=True), "float32")
    empty = (lens == 0) | ~mapped.any(dim=1).numpy()
    assert torch.equal(got[empty], torch.zeros_like(got[empty]))


# ---------------------------------------------------------------------------
# dispatch: a CPU tensor takes the plain version; the kernel needs the card
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(5)
    (q, _), (k, _), (v, _) = _arrs(rng, "float32", (1, 32, 4, 16), (1, 32, 2, 16),
                                   (1, 32, 2, 16))
    counters = (flash_attention_cuda, paged_attention_cuda, decode_attention_cuda, wkv6_cuda)
    before = [c.launches for c in counters]
    assert torch.equal(ops.flash_attention(q, k, v, q_block=16, kv_block=16),
                       flash_attention_plain(q, k, v, q_block=16, kv_block=16))
    pool = k.reshape(2, 16, 2, 16)
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    lengths = torch.tensor([20], dtype=torch.int32)
    assert torch.equal(ops.paged_attention(q[:, :1], pool, pool, table, lengths),
                       paged_attention_plain(q[:, :1], pool, pool, table, lengths))
    assert torch.equal(ops.decode_attention(q[:, :1], k, v, lengths),
                       decode_attention_plain(q[:, :1], k, v, lengths))
    r = q[:, :, :2]
    w = torch.full_like(r, 0.9)
    u = torch.zeros(2, 16)
    for got, want in zip(ops.wkv6(r, r, r, w, u), wkv6_plain(r, r, r, w, u)):
        assert torch.equal(got, want)
    assert [c.launches for c in counters] == before


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_cuda(q, q, q)
    table = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        paged_attention_cuda(q[:, :1], q, q, table, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="not a CUDA device"):
        decode_attention_cuda(q[:, :1], q, q, torch.ones(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="not a CUDA device"):
        wkv6_cuda(q, q, q, q, torch.zeros(2, 16))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    for name in build.SOURCES:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.load(name)
    assert not (tmp_path / "build").exists()


def test_no_launcher_sets_a_shared_memory_attribute_once_a_process():
    """``cudaFuncAttributeMaxDynamicSharedMemorySize`` belongs to a device: a
    launcher that sets it behind a flag kept once a process (a ``static
    bool``) finds it unset on a second card, whose launch is then refused.
    No source keeps such a flag; the flash, wide-decode and WKV6 backward
    launchers set it once a device (``allow_smem_per_device``), the others on
    every launch."""
    for path in sorted(build.CSRC.glob("*.cu*")):
        assert not re.search(r"static\s+bool", path.read_text()), path.name
    for name in ("flash_attention.cu", "decode_attention.cu", "rwkv6_scan_bwd.cu"):
        assert "allow_smem_per_device(" in (build.CSRC / name).read_text(), name


def test_held_zeros_is_one_buffer_an_owner_device_and_stream_grown_only_when_short():
    """``scratch.held_zeros`` hands each owner its own zeroed scratch a
    device and stream, the same tensor again while it is long enough (a
    CUDA graph keeps its address) and a larger zeroed one when it is not;
    the RG-LRU chain's words are 8 bytes, a counter and one a (chunk but
    the last, row, channel)."""
    from repro_torch.kernels.rglru_scan import _chain_words
    from repro_torch.kernels.scratch import held_zeros

    cpu = torch.device("cpu")
    a = held_zeros("test: a", cpu, 0, 5, torch.int32)
    assert a.dtype == torch.int32 and a.numel() == 5 and not a.any()
    assert held_zeros("test: a", cpu, 0, 3, torch.int32) is a
    assert held_zeros("test: b", cpu, 0, 3, torch.int32) is not a
    grown = held_zeros("test: a", cpu, 0, 9, torch.int32)
    assert grown is not a and grown.numel() == 9 and not grown.any()
    words = _chain_words(cpu, 0, 2, 3, 4)
    assert words.dtype == torch.int64 and words.numel() == 1 + 3 * 2 * 3 and not words.any()
    assert _chain_words(cpu, 0, 2, 3, 2) is words


def test_held_zeros_gives_two_streams_two_buffers():
    """Two chained launches in flight on two streams of one device must not
    share a ticket counter or flags (one grid's last ticket would reset the
    counter under the other), so each stream holds its own scratch, and
    each keeps it across calls."""
    from repro_torch.kernels.rglru_scan import _chain_words
    from repro_torch.kernels.scratch import held_zeros

    cpu = torch.device("cpu")
    one, two = (held_zeros("test: streams", cpu, s, 4, torch.int32) for s in (0x11, 0x22))
    assert one is not two and one.data_ptr() != two.data_ptr()
    assert held_zeros("test: streams", cpu, 0x11, 4, torch.int32) is one
    assert held_zeros("test: streams", cpu, 0x22, 2, torch.int32) is two
    assert _chain_words(cpu, 0x11, 2, 3, 4) is not _chain_words(cpu, 0x22, 2, 3, 4)
