"""The RG-LRU kernel's and the wide-head ring decode's own arithmetic on the
CPU, held against the references.

Both kernels sit on the RecurrentGemma-9B path.  ``csrc/rglru_scan.cu`` and
``csrc/decode_attention.cu`` run only on the card; ``chip_smoke.py`` holds
them against their plain versions there.

RG-LRU.  ``_rglru_design`` repeats, in plain
fp32 PyTorch, what its blocks compute and in which order: one block per
(row, channels, chunk of ``CHUNK`` tokens), taken in ticket order
(chunk-major); each first takes its gates, a_t = exp(a_log_t) and
g_t = sqrt(max(1 − e2_t, 1e-12)) · x_t with e2_t = exp(2a_t) correctly
rounded where 2a_t > −0.5 and a_t · a_t below; then takes the state its
predecessor's walk ended in from that chunk's word (zeroing it), walks its
tokens h_t = a_t · h_{t−1} + g_t, and publishes the end (the final state
after the last chunk).

The design is held to ``rglru_plain`` at ``PLAIN_TOL`` (2e-5 in fp32, 2e-2
in bf16, scaled by 1 + |h|, as ``chip_smoke.py`` holds the kernel) and, in
fp32, to the token-by-token oracle at ``ORACLE_TOL`` = 1e-5; to the JAX
package's ``_rglru_jnp`` and ``rglru_pallas`` (interpret mode) at 1e-5 as
well, except at 3,072 tokens of gates within 1e-6 of 0 (``JAX_DRIFT_TOL``,
below).  A test pins why the chunks chain the walk's own state and not a
composed ``P · h_in + L``.

Ring decode (D in {128, 256}).  ``_ring_design`` repeats the wide-head
kernel: the sequence in ``wide_pieces`` pieces of ``wide_piece_len``
positions (at least two 16-position tiles each, whole clusters of 8), a
block per (piece, KV head and slice of 16 query heads, row); each walks its
tiles with an online softmax, P rounded to bf16 for the bf16 route's
tensor-core product while the sums stay fp32; the 8 pieces of a cluster
merge their partials (m, l, acc), and the clusters' partials merge last.
It is held to ``decode_attention_plain`` and ``_decode_jnp`` at 2e-5 (fp32,
absolute) and 2e-2 (bf16, over each output row's largest value, as
``chip_smoke.py`` holds the kernel), at the lengths 0, 1, a piece ± 1, the
full ring and past it, and a length-0 row must come out exactly zero.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.rglru_scan import rglru_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (WIDE_GROUP, WIDE_HEADS, WIDE_TILE,
                                                  decode_attention_plain, wide_piece_len,
                                                  wide_pieces)
from repro_torch.kernels.rglru_scan import CHUNK, rglru_plain

PLAIN_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
ORACLE_TOL = 1e-5
# Over 3,072 steps of gates within 1e-6 of 0 each fp32 step a · h moves h by
# less than a unit of its last place, and the roundings add up past 1e-5.
# The JAX references round otherwise (the Pallas body's a · h + g is one
# fused multiply-add under XLA's CPU compiler, the associative scan
# multiplies in a tree), so there they stand that far from the
# token-by-token oracle, and from the design, which steps as the oracle does.
JAX_DRIFT_TOL = 1e-4
FP64_BAND = -0.5
C = CHUNK


def _inputs(rng, B, T, W, gates):
    """x ~ N(0, 1); log-gates ``mild`` −|N(0, 0.5)|, ``strong`` U(−20, 0), or
    ``near0`` within 1e-6 of 0, where 1 − exp(2a) keeps only a few bits; a
    state ~ N(0, 1)."""
    x = rng.normal(size=(B, T, W)).astype(np.float32)
    a_log = {"mild": lambda: -np.abs(0.5 * rng.normal(size=(B, T, W))),
             "strong": lambda: -rng.uniform(0.0, 20.0, (B, T, W)),
             "near0": lambda: -rng.uniform(0.0, 1e-6, (B, T, W))}[gates]()
    return x, a_log.astype(np.float32), rng.normal(size=(B, W)).astype(np.float32)


def _gates(x, a_log):
    """The kernel's gates: a = exp(a_log), and g with exp(2a) correctly
    rounded where 2a > −0.5, a · a below."""
    al = a_log.float()
    a = torch.exp(al)
    e2 = torch.where(2.0 * al > FP64_BAND, torch.exp(2.0 * al.double()).float(), a * a)
    return a, torch.sqrt(torch.clamp_min(1.0 - e2, 1e-12)) * x.float()


def _rglru_design(x, a_log, state=None):
    """The kernel's blocks in ticket order, every (row, channel) of a chunk
    at once; returns ``(h in x's dtype, final state)`` and checks that every
    published word was read (the kernel leaves its scratch zeroed)."""
    B, T, W = x.shape
    a, g = _gates(x, a_log)
    h0 = torch.zeros(B, W) if state is None else state.float()
    n_chunks = -(-T // C)
    words, out, final = {}, torch.empty(B, T, W), None
    for c in range(n_chunks):                   # chunk-major tickets
        h = h0 if c == 0 else words.pop(c - 1)
        for t in range(c * C, min(T, (c + 1) * C)):
            h = a[:, t] * h + g[:, t]
            out[:, t] = h
        if c + 1 < n_chunks:
            words[c] = h
        else:
            final = h
    assert not words
    return out.to(x.dtype), final


def _composed(x, a_log, state, decay):
    """The form the kernel does not take: each chunk hands on P · h_in + L,
    L its walk from 0 and P its decay, ``exp`` of the log-gate sum or the
    product of the rounded gates; the outputs walk from that state."""
    B, T, W = x.shape
    a, g = _gates(x, a_log)
    h, out = state.float(), torch.empty(B, T, W)
    for c0 in range(0, T, C):
        idx = range(c0, min(T, c0 + C))
        L, P, S, hh = torch.zeros(B, W), torch.ones(B, W), torch.zeros(B, W), h
        for t in idx:
            L = a[:, t] * L + g[:, t]
            P = P * a[:, t]
            S = S + a_log[:, t]
            hh = a[:, t] * hh + g[:, t]
            out[:, t] = hh
        h = (torch.exp(S) if decay == "exp-sum" else P) * h + L
    return out, h


def _scaled(got, want):
    got = got.float()
    if not torch.is_tensor(want):
        want = torch.from_numpy(np.array(want, np.float32))
    want = want.float()
    return ((got - want).abs() / (1 + want.abs())).max().item()


@pytest.mark.parametrize("carried", [True, False])
@pytest.mark.parametrize("gates", ["mild", "strong", "near0"])
@pytest.mark.parametrize("T", [1, C - 1, C, C + 1, 3072])
def test_rglru_design_matches_plain_oracle_and_jax(T, gates, carried):
    """fp32: the design against ``rglru_plain``, the oracle, ``_rglru_jnp``
    and ``rglru_pallas`` (interpret mode, chunk 32 and a ragged last chunk
    where T allows), outputs and final state, with a carried state or none."""
    rng = np.random.default_rng(T + 3 * len(gates) + 11 * carried)
    x, a_log, s0 = _inputs(rng, 2, T, 48, gates)
    xt, at = torch.from_numpy(x), torch.from_numpy(a_log)
    st = torch.from_numpy(s0) if carried else None
    h, h_T = _rglru_design(xt, at, st)
    for want in (rglru_plain(xt, at, st), ref.rglru_ref(xt, at, st)):
        assert _scaled(h, want[0]) <= ORACLE_TOL and _scaled(h_T, want[1]) <= ORACLE_TOL
    jst = jnp.asarray(s0) if carried else None
    jx, ja = jnp.asarray(x), jnp.asarray(a_log)
    jax_tol = JAX_DRIFT_TOL if (gates, T) == ("near0", 3072) else ORACLE_TOL
    for want in (jops._rglru_jnp(jx, ja, jst),
                 rglru_pallas(jx, ja, state=jst, chunk=32, w_block=16, interpret=True)):
        assert _scaled(h, want[0]) <= jax_tol and _scaled(h_T, want[1]) <= jax_tol


@pytest.mark.parametrize("gates", ["mild", "strong", "near0"])
@pytest.mark.parametrize("T", [1, C + 1, 3 * C - 1, 1000])
def test_rglru_design_bfloat16_rounds_the_output_only(T, gates):
    """bf16 x: the design against ``rglru_plain`` at the card's bf16
    tolerance, the final state (fp32) at the fp32 one."""
    rng = np.random.default_rng(100 + T + len(gates))
    x, a_log, s0 = _inputs(rng, 2, T, 40, gates)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    at, st = torch.from_numpy(a_log), torch.from_numpy(s0)
    h, h_T = _rglru_design(xt, at, st)
    want_h, want_s = rglru_plain(xt, at, st)
    assert h.dtype == torch.bfloat16
    assert _scaled(h, want_h) <= PLAIN_TOL[torch.bfloat16]
    assert _scaled(h_T, want_s) <= PLAIN_TOL[torch.float32]


def test_rglru_design_is_the_plain_recurrence_inside_the_band():
    """Where every 2a > −0.5 the gates are the plain version's and every
    chunk steps its recurrence, so the design equals it bit for bit."""
    rng = np.random.default_rng(5)
    x, a_log, s0 = _inputs(rng, 3, 5 * C + 3, 32, "mild")
    a_log = np.maximum(a_log, np.float32(-0.24))
    args = [torch.from_numpy(v) for v in (x, a_log, s0)]
    for got, want in zip(_rglru_design(*args), rglru_plain(*args)):
        assert torch.equal(got, want)


@pytest.mark.parametrize("decay", ["exp-sum", "product"])
def test_rglru_composed_chunk_state_drifts_where_the_walk_does_not(decay):
    """At 3,072 tokens of gates within 1e-6 of 0, a chunk state composed as
    P · h_in + L ends over 1e-5 from the oracle, whichever way P is taken;
    the walk's own state, which the kernel hands on, stays within it."""
    rng = np.random.default_rng(9)
    x, a_log, s0 = (torch.from_numpy(v) for v in _inputs(rng, 2, 3072, 32, "near0"))
    want_h, want_s = ref.rglru_ref(x, a_log, s0)
    h, h_T = _composed(x, a_log, s0, decay)
    assert max(_scaled(h, want_h), _scaled(h_T, want_s)) > ORACLE_TOL
    h, h_T = _rglru_design(x, a_log, s0)
    assert max(_scaled(h, want_h), _scaled(h_T, want_s)) <= ORACLE_TOL


# ---------------------------------------------------------------------------
# ring decode at head widths 128 and 256
# ---------------------------------------------------------------------------

NEG_INF = -1e30
RING = 2048


def _merge(parts):
    """Rescale partials (m, l, acc) to the largest m and sum them."""
    m_all = torch.stack([m for m, _, _ in parts])
    mx = m_all.amax(dim=0)
    f = torch.exp(m_all - mx)
    l_sum = sum(f[j] * parts[j][1] for j in range(len(parts)))
    a_sum = sum(f[j][:, None] * parts[j][2] for j in range(len(parts)))
    return mx, l_sum, a_sum


def _ring_design(q, k, v, lengths):
    """q: (B, 1, H, D); k/v: (B, S, Hk, D); lengths: (B,).  The wide-head
    kernel's pieces, tiles, online softmax and two-level merge, in fp32 on
    the inputs' values; P is rounded to bf16 where the inputs are bf16."""
    B, _, H, D = q.shape
    S, Hk = k.shape[1], k.shape[2]
    G = H // Hk
    n_pieces, per = wide_pieces(S), wide_piece_len(S)
    bf16 = q.dtype == torch.bfloat16
    out = torch.zeros(B, H, D)
    for b in range(B):
        n = max(0, min(int(lengths[b]), S))
        for h in range(Hk):
            for g0 in range(0, G, WIDE_HEADS):
                ng = min(WIDE_HEADS, G - g0)
                qs = torch.zeros(WIDE_HEADS, D)
                qs[:ng] = q[b, 0, h * G + g0:h * G + g0 + ng].float()
                parts = []
                for piece in range(n_pieces):
                    p0 = piece * per
                    live = max(0, min(per, n - p0))
                    m, l, acc = torch.full((WIDE_HEADS,), NEG_INF), torch.zeros(WIDE_HEADS), \
                        torch.zeros(WIDE_HEADS, D)
                    for t0 in range(p0, p0 + live, WIDE_TILE):
                        pos = torch.arange(t0, min(t0 + WIDE_TILE, p0 + live))
                        s = qs @ k[b, pos, h].float().T / np.sqrt(D)
                        m_new = torch.maximum(m, s.amax(dim=-1))
                        c = torch.exp(m - m_new)
                        p = torch.exp(s - m_new[:, None])
                        l = l * c + p.sum(dim=-1)
                        pv = p.to(torch.bfloat16).float() if bf16 else p
                        acc = acc * c[:, None] + pv @ v[b, pos, h].float()
                        m = m_new
                    parts.append((m, l, acc))
                groups = [_merge(parts[i:i + WIDE_GROUP])
                          for i in range(0, n_pieces, WIDE_GROUP)]
                _, l_sum, a_sum = groups[0] if len(groups) == 1 else _merge(groups)
                o = a_sum / l_sum.clamp_min(1e-30)[:, None]
                out[b, h * G + g0:h * G + g0 + ng] = o[:ng]
    return out.reshape(B, 1, H, D).to(q.dtype)


def _row_rel(got, want):
    """Max over output rows of max|got − want| over the row's max|want| (a
    zero row taken as 1e-6), as ``chip_smoke.py`` holds bf16 rows."""
    got = got.float()
    want = want.float() if torch.is_tensor(want) else torch.from_numpy(np.array(want, np.float32))
    d = (got - want).abs().amax(-1)
    return (d / want.abs().amax(-1).clamp(min=1e-6)).max().item()


def test_wide_pieces_cover_the_ring_in_clusters_of_8():
    """At least two tiles a piece, whole clusters of 8 pieces, at most 64
    pieces (8 clusters, so the second merge level reads at most 8)."""
    assert wide_pieces(0) == 8 and wide_pieces(1) == 8
    assert wide_pieces(RING) == 64 and wide_piece_len(RING) == 2 * WIDE_TILE
    assert wide_pieces(300) == 16
    for S in (31, 32, 33, 1000, RING, 4097, 10000):
        n, per = wide_pieces(S), wide_piece_len(S)
        assert n % WIDE_GROUP == 0 and n <= 64 and per >= 2 * WIDE_TILE
        assert n * per >= S > (n - WIDE_GROUP) * per


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 8, 16, 20])
@pytest.mark.parametrize("D", [128, 256])
def test_ring_design_matches_plain_and_jax(D, G, dtype):
    """Lengths 0, 1, a piece ± 1, the full ring and past it on a 2,048-slot
    ring (64 pieces, 8 groups: both merge levels); G = 20 takes two slices,
    G < 16 pads the slice's rows; Hk = 2 at G = 8."""
    piece = wide_piece_len(RING)
    lens = np.asarray([0, 1, piece - 1, piece, piece + 1, RING, RING + 5], np.int32)
    Hk = 2 if G == 8 else 1
    B, H = len(lens), G * Hk
    rng = np.random.default_rng(D + G)
    torch_dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    q, k, v = (torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(torch_dtype)
               for shape in ((B, 1, H, D), (B, RING, Hk, D), (B, RING, Hk, D)))
    got = _ring_design(q, k, v, torch.from_numpy(lens))
    assert got.dtype == torch_dtype
    want = decode_attention_plain(q, k, v, torch.from_numpy(lens))
    jwant = jops._decode_jnp(*(jnp.asarray(t.float().numpy()) for t in (q, k, v)),
                             jnp.asarray(lens))
    for w in (want, jwant):
        if dtype == "float32":
            np.testing.assert_allclose(got.numpy(), np.asarray(w, np.float32), atol=2e-5,
                                       rtol=0)
        else:
            assert _row_rel(got, w) <= 2e-2
    assert torch.equal(got[0], torch.zeros_like(got[0]))
