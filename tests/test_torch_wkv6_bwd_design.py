"""The WKV6 backward kernel's own arithmetic on the CPU, held against the references.

``csrc/rwkv6_scan_bwd.cu`` runs only on the card; ``chip_smoke.py`` holds it
against ``wkv6_backward_plain`` there.  Here ``_bwd_design`` repeats, in
plain fp32 PyTorch, what its launches compute and in which order:

1. the forward's own chain (``wkv6_bwd_states_kernel``, the prefill's body
   with no outputs): S_{c+1} = e^{LC} ⊙ S_c + ΔS_c, the product and the sum
   rounded apart, written for every chunk start;
2. one block per (chunk, head, row), taken in reverse chunk-major ticket
   order (``wkv6_bwd_kernel``).  Before it waits, a block takes the group
   sums of the log-decays (sums of one sign, as the forward's), the pair
   decays e^{Le_t − L_s} (one exp each, computed once by row owners and once
   by column owners), ∂r (it needs only S_c), ΔG_c = Σ_t (e^{Le_t} r_t)ᵀ
   do_t, the intra-chunk parts of ∂k and ∂v, and the parts of ∂lw that do
   not need G_{c+1}; then it takes G_{c+1} from its (row, head)'s slot,
   writes G_c = e^{LC} ⊙ G_{c+1} + ΔG_c to the other slot (or ∂state₀),
   and finishes ∂k, ∂v and ∂lw;
3. ∂u, the (row, chunk) shares added in a fixed order.

With A[t, s] = do_t · v_s, every term of ∂lw_t spans token t, so holds w_t
in its exponent:

    ∂lw_t = e^{LC} ⊙ rowsum(G_{c+1} ⊙ S_c) + Σ_{s<t} k_s ⊙ e^{LC − L_s} ⊙ (G_{c+1} v_s)
            + Σ_{s'>t} r_s' ⊙ e^{Le_s'} ⊙ (S_c do_s') + γ_t,
    γ_t = Σ_{s<t<s'} e^{Le_s' − L_s} ⊙ r_s' ⊙ k_s · A[s', s],

and γ is built from sums over the tiles of four-token groups that only add:
the tiles strictly around t's group, the row sums of t's group's rows after
t, the column sums of its columns before t, and the pairs inside the group.
The design is held at ``TOL`` = 1e-4 row-relative to ``wkv6_backward_plain``
(float64 token by token) and to ``jax.vjp`` of ``_wkv6_jnp`` and
``wkv6_ref``, and ∂w at w = 1e-12 inside a chunk within 1e-4 of the exact
value.  A test pins why ∂lw is not taken as the usual chunked-GLA
difference of sums r ⊙ ∂r − k ⊙ ∂k.
"""
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels.rwkv6_scan import CHUNK, _dw_from_dlw, wkv6_backward_plain

ROOT = Path(__file__).resolve().parents[1]
TOL = 1e-4
C = CHUNK
NG = C // 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _group_sums(lw):
    """The forward's log-decay sums for one chunk's logs ``lw`` (C, D), every
    one a sum of terms of one sign: A[t] over the tokens of t's group of four
    before t, B[t] over those after t, P[g] and Q[g] over the groups before
    and after g, G[f, h] over the groups strictly between h < f (zero
    elsewhere), and the chunk's total LC."""
    A, Bs = torch.empty_like(lw), torch.empty_like(lw)
    tot = []
    for g in range(NG):
        a, b = torch.zeros(lw.shape[1]), torch.zeros(lw.shape[1])
        for i in range(4):
            A[4 * g + i] = a
            a = a + lw[4 * g + i]
        for i in reversed(range(4)):
            Bs[4 * g + i] = b
            b = b + lw[4 * g + i]
        tot.append(a)
    P, Q = torch.empty(NG, lw.shape[1]), torch.empty(NG, lw.shape[1])
    p, q = torch.zeros(lw.shape[1]), torch.zeros(lw.shape[1])
    for g in range(NG):
        P[g] = p
        p = p + tot[g]
    for g in reversed(range(NG)):
        Q[g] = q
        q = q + tot[g]
    G = torch.zeros(NG, NG, lw.shape[1])
    for f in range(1, NG):
        acc = torch.zeros(lw.shape[1])
        for h in reversed(range(f)):
            G[f, h] = acc
            acc = acc + tot[h]
    return A, Bs, P, Q, G, p


def _pair_decays(lw, A, Bs, G):
    """e^{Le_t − L_s} for s < t (zero elsewhere), (C, C, D): across groups
    one exp of (A_t + G) + B_s, inside a group one exp of the logs strictly
    between s and t (none, one or two of them)."""
    t = torch.arange(C)
    gt = t // 4
    ex = (A[:, None] + G[gt[:, None], gt[None, :]]) + Bs[None, :]
    for s in range(C):
        for tt in range(s + 1, 4 * (s // 4) + 4):
            e = torch.zeros(lw.shape[1])
            for j in range(s + 1, tt):
                e = e + lw[j]
            ex[tt, s] = e
    lower = (t[:, None] > t[None, :])[..., None]
    return torch.where(lower, torch.exp(torch.where(lower, ex, 0.0)), 0.0)


def _straddle(M):
    """γ_t = Σ_{s<t<s'} M[s', s] from the tile pieces the kernel adds: the
    tiles strictly around t's group and the column sums of its columns
    before t (their rows in later groups), both from the column owners,
    onto the row owners' row sums of the group's rows after t (their
    columns in earlier groups) and the pairs inside the group."""
    D = M.shape[-1]
    tiles = M.reshape(NG, 4, NG, 4, D).sum((1, 3))                     # [f, h]
    g_of = torch.arange(C) // 4
    earlier = (g_of[None, :] < g_of[:, None])[..., None]                # s's group before t's
    rows = torch.where(earlier, M, 0.0).sum(1)                          # R[t]
    cols = torch.where(earlier, M, 0.0).sum(0)                          # Cc[s]
    gam = torch.empty(C, D)
    for g in range(NG):
        mid = torch.zeros(D)
        for h in range(g):
            for f in range(g + 1, NG):
                mid = mid + tiles[f, h]
        for c in range(4):
            tau = 4 * g + c
            after = torch.zeros(D)
            for a in range(c + 1, 4):
                after = after + rows[4 * g + a]
            before = torch.zeros(D)
            for b in range(c):
                before = before + cols[4 * g + b]
            inside = torch.zeros(D)
            for a in range(c + 1, 4):
                for b in range(c):
                    inside = inside + M[4 * g + a, 4 * g + b]
            gam[tau] = (mid + before) + (after + inside)
    return gam


def _chunk(rc, kc, vc, doc, lw, u, S_c, G_next, by_difference=False):
    """One block's arithmetic for one chunk: returns (dr, dk, dv, dlw, its
    share of ∂u, G_c).  Everything before G_next is what the kernel computes
    before it waits."""
    A, Bs, P, Q, G, LC = _group_sums(lw)
    g_of = torch.arange(C) // 4
    vd = (vc.double() * doc.double()).sum(1).float()                    # fp64, rounded once
    ruk = (rc.double() * u.double() * kc.double()).sum(1).float()
    lower = torch.arange(C)[:, None] > torch.arange(C)[None, :]
    Adm = torch.where(lower, doc @ vc.T, 0.0)                           # A[t, s], s < t
    E = _pair_decays(lw, A, Bs, G)
    ek = E * kc[None]
    dr_intra = (ek * Adm[..., None]).sum(1)                             # row owners
    att = (ek * rc[:, None]).sum(2)
    M = (ek * rc[:, None]) * Adm[..., None]
    X_col = (E * rc[:, None]) * Adm[..., None]                          # column owners
    dk_intra = X_col.sum(0)
    gam = _straddle(M)
    e_le = torch.exp(P[g_of] + A)
    e_k = torch.exp(Bs + Q[g_of])
    q = rc * e_le
    kd = kc * e_k
    SD = doc @ S_c.T                                                    # (S_c do_t)_i
    dr = e_le * SD + (dr_intra + (u * kc) * vd[:, None])
    beta = q * SD
    dG = q.T @ doc
    pre = torch.empty_like(gam)
    acc = torch.zeros(lw.shape[1])
    for t in reversed(range(C)):
        pre[t] = acc + gam[t]
        acc = acc + beta[t]
    dv_pre = att.T @ doc + ruk[:, None] * doc
    dk_pre = dk_intra + (u * rc) * vd[:, None]
    du = (rc * kc * vd[:, None]).sum(0)
    e_lc = torch.exp(LC)
    # ---- the wait: G_{c+1} ----
    G_c = e_lc[:, None] * G_next + dG
    GV = vc @ G_next.T                                                  # (G v_t)_i
    dk = e_k * GV + dk_pre
    alpha = kd * GV
    dv = kd @ G_next + dv_pre
    X = (G_next * S_c).sum(1)
    dlw = torch.empty_like(gam)
    acc = e_lc * X
    for t in range(C):
        dlw[t] = acc + pre[t]
        acc = acc + alpha[t]
    if by_difference:
        # the chunked-GLA form: ∂lw_t = F_{t+1} − k_t ⊙ (G_{t+1} v_t), F_t the
        # row sums of G_t ⊙ S_t, run back from F_C as F_t = F_{t+1} +
        # r_t ⊙ (S_t do_t) − k_t ⊙ (G_{t+1} v_t), the state terms of ∂r and ∂k
        f_next = (G_next * (e_lc[:, None] * S_c + kd.T @ vc)).sum(1)
        dr_s, dk_s = e_le * SD + dr_intra, e_k * GV + dk_intra
        for t in reversed(range(C)):
            dlw[t] = f_next - kc[t] * dk_s[t]
            f_next = f_next + (rc[t] * dr_s[t] - kc[t] * dk_s[t])
    return dr, dk, dv, dlw, du, G_c


def _bwd_design(r, k, v, w, u, do, state=None, d_state=None, by_difference=False):
    """The kernel's three launches; returns ``(dr, dk, dv, dw, du, d_state0)``
    as ``wkv6_backward_plain`` does, fp32 (dr/dk/dv/du rounded to r's dtype).
    The model walks the reverse tickets in order and asserts that each
    block's successor chunk has published, which is what lets the kernel's
    waits end."""
    B, T, H, D = r.shape
    n = -(-T // C)
    pad = n * C - T
    r_, k_, v_, do_ = (F.pad(x.float(), (0, 0, 0, 0, 0, pad)) for x in (r, k, v, do))
    lw_all = F.pad(torch.log(w.float().clamp(1e-12, 1.0)), (0, 0, 0, 0, 0, pad))   # w = 1
    u32 = u.float()
    # launch 1: the state entering every chunk, the forward's chain
    S = torch.zeros(B, H, n, D, D)
    if state is not None:
        S[:, :, 0] = state.float()
    for c in range(n - 1):
        for b in range(B):
            for h in range(H):
                sl = slice(c * C, (c + 1) * C)
                _, Bs, _, Q, _, LC = _group_sums(lw_all[b, sl, h])
                kd = k_[b, sl, h] * torch.exp(Bs + Q[torch.arange(C) // 4])
                S[b, h, c + 1] = torch.exp(LC)[:, None] * S[b, h, c] + kd.T @ v_[b, sl, h]
    # launch 2: reverse chunk-major tickets, G in two slots a (row, head)
    BH = B * H
    slots = torch.zeros(B, H, 2, D, D)
    published = torch.zeros(BH, dtype=torch.int64)
    outs = [torch.zeros(B, n * C, H, D) for _ in range(4)]
    du_rows = torch.zeros(B, n, H, D)
    ds0 = torch.empty(B, H, D, D)
    for ticket in range(n * BH):
        c, bh = n - 1 - ticket // BH, ticket % BH
        b, h = divmod(bh, H)
        sl = slice(c * C, (c + 1) * C)
        assert published[bh] == n - 1 - c
        if c == n - 1:
            G_next = torch.zeros(D, D) if d_state is None else d_state[b, h].float()
        else:
            G_next = slots[b, h, (c + 1) % 2].clone()
        *grads, du_rows[b, c, h], G_c = _chunk(r_[b, sl, h], k_[b, sl, h], v_[b, sl, h],
                                               do_[b, sl, h], lw_all[b, sl, h], u32[h],
                                               S[b, h, c], G_next, by_difference)
        for o, g in zip(outs, grads):
            o[b, sl, h] = g
        if c == 0:
            ds0[b, h] = G_c
        else:
            slots[b, h, c % 2] = G_c
            published[bh] += 1
    # launch 3: ∂u, the shares in a fixed order
    du = torch.zeros(H, D)
    for b in range(B):
        for c in range(n):
            du = du + du_rows[b, c]
    dr, dk, dv, dlw = (o[:, :T] for o in outs)
    return (dr.to(r.dtype), dk.to(k.dtype), dv.to(v.dtype), _dw_from_dlw(dlw, w),
            du.to(u.dtype), ds0)


def _inputs(rng, B, T, H, D, decay, state):
    """r/k/v/do ~ N(0, 1), u ~ U(−0.5, 0.5), and decays ``rwkv`` RWKV6's own
    init exp(−exp(U(−0.5, 0.5))), ``mild`` exp(−exp(U(−3, 1))) (where
    ``_wkv6_jnp`` is exact to fp32), ``tiny`` U(1e-12, 1) with a sixteenth
    set to 1e-12, or ``wide`` exp(−exp(U(−6, 3.32))), from 0.998 down to
    1e-12 with as many near 1 as near 1e-12; with ``state`` a carried state
    and a final-state gradient, else None for both."""
    r, k, v, do = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(4))
    if decay == "rwkv":
        w = np.exp(-np.exp(rng.uniform(-0.5, 0.5, (B, T, H, D))))
    elif decay == "mild":
        w = np.exp(-np.exp(rng.uniform(-3.0, 1.0, (B, T, H, D))))
    elif decay == "wide":
        w = np.exp(-np.exp(rng.uniform(-6.0, 3.32, (B, T, H, D))))
    else:
        w = np.clip(rng.uniform(0.0, 1.0, (B, T, H, D)), 1e-12, 1.0)
        w[rng.uniform(size=(B, T, H, D)) < 1 / 16] = 1e-12
    u = rng.uniform(-0.5, 0.5, (H, D)).astype(np.float32)
    s0 = (0.3 * rng.normal(size=(B, H, D, D))).astype(np.float32) if state else None
    ds = rng.normal(size=(B, H, D, D)).astype(np.float32) if state else None
    return r, k, v, w.astype(np.float32), u, do, s0, ds


def _torch(arrs):
    return [None if a is None else torch.from_numpy(a) for a in arrs]


def _row_rel(got, want):
    """Max over rows (the last axis) of max|got − want| over the row's
    max|want| (a zero row taken as 1e-6), as ``chip_smoke.py`` holds the
    kernel."""
    got, want = (x.double() if torch.is_tensor(x) else torch.as_tensor(np.asarray(x, np.float64))
                 for x in (got, want))
    d = (got - want).abs().amax(-1)
    return (d / want.abs().amax(-1).clamp(min=1e-6)).max().item()


NAMES = ("dr", "dk", "dv", "dw", "du", "dstate")


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("decay", ["rwkv", "tiny", "wide"])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 65, 97])
def test_bwd_design_matches_plain(T, D, decay, state):
    rng = np.random.default_rng(1000 * T + 10 * D + 3 * len(decay) + state)
    args = _torch(_inputs(rng, 2, T, 2, D, decay, state))
    got = _bwd_design(*args)
    want = wkv6_backward_plain(*args)
    for name, g, wnt in zip(NAMES, got, want):
        assert _row_rel(g, wnt) <= TOL, (name, _row_rel(g, wnt))


@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("T", [31, 65])
def test_bwd_design_matches_jax_vjp(T, state):
    """Against ``jax.vjp`` of ``_wkv6_jnp`` and the token-by-token oracle
    ``wkv6_ref``, at the decays where the training tests hold the plain
    version to them, every gradient row-relative at 1e-4 but one: autograd
    through ``_wkv6_jnp``'s chunks takes ∂lw as a difference of sums, so
    where the exact ∂w is 0 (the first token with no state: every term of
    ∂lw_0 holds S_0) it gives fp32 noise of ~1e-6; there its ∂w is held at
    1e-4 of its largest value, as the training tests hold the plain
    version."""
    arrs = _inputs(np.random.default_rng(7 * T + state), 2, T, 3, 16, "mild", state)
    r, k, v, w, u, do, s0, ds = arrs
    got = _bwd_design(*_torch(arrs))
    s0j = jnp.zeros((2, 3, 16, 16), jnp.float32) if s0 is None else jnp.asarray(s0)
    dsj = jnp.zeros_like(s0j) if ds is None else jnp.asarray(ds)
    for fname, fn in (("_wkv6_jnp", lambda *a: jops._wkv6_jnp(*a, C)),
                      ("wkv6_ref", jref.wkv6_ref)):
        _, vjp = jax.vjp(fn, *map(jnp.asarray, (r, k, v, w, u)), s0j)
        want = vjp((jnp.asarray(do), dsj))
        for name, g, wnt in zip(NAMES, got, want):
            if name == "dstate" and not state:
                continue
            if name == "dw" and fname == "_wkv6_jnp":
                err = np.abs(g.numpy() - np.asarray(wnt)).max()
                assert err <= TOL * np.abs(np.asarray(wnt)).max(), (fname, name, err)
                continue
            assert _row_rel(g, wnt) <= TOL, (fname, name, _row_rel(g, wnt))


def _tiny_mid_chunk(seed, T=70):
    """Wide decays with every channel's decay 1e-12 at tokens 13 and 45
    (inside the first and second chunks) and a carried state and gradient."""
    arrs = list(_inputs(np.random.default_rng(seed), 2, T, 2, 16, "wide", True))
    arrs[3][:, [13, 45]] = np.float32(1e-12)
    return _torch(arrs)


def test_dw_at_tiny_decays_keeps_its_relative_precision():
    """∂w = ∂lw / w at w = 1e-12 inside a chunk: every term of the design's
    ∂lw spans the token, so ∂w there is within 1e-4 of the exact value,
    element by element."""
    args = _tiny_mid_chunk(3)
    got = _bwd_design(*args)[3]
    want = wkv6_backward_plain(*args)[3]
    sel = got[:, [13, 45]].double(), want[:, [13, 45]].double()
    rel = ((sel[0] - sel[1]).abs() / sel[1].abs()).max().item()
    assert rel <= TOL, rel


def test_dlw_as_a_difference_of_sums_loses_the_tiny_decays():
    """The usual chunked-GLA ∂lw, F_{t+1} − k ⊙ ∂k with F a running sum of
    r ⊙ ∂r − k ⊙ ∂k, is right to fp32's absolute error only: where w is
    1e-12 that error divided by w leaves ∂w far outside 1e-4, while the
    design's other gradients are those of the sum form."""
    args = _tiny_mid_chunk(3)
    want = wkv6_backward_plain(*args)
    diff = _bwd_design(*args, by_difference=True)
    sel = diff[3][:, [13, 45]].double(), want[3][:, [13, 45]].double()
    assert ((sel[0] - sel[1]).abs() / sel[1].abs()).max().item() > 100 * TOL
    for name, g, wnt in zip(NAMES, diff, want):
        if name != "dw":
            assert _row_rel(g, wnt) <= TOL, name


def test_bfloat16_rounds_the_gradients_once():
    """bf16 r/k/v/u/do: the design's gradients are the plain version's
    within the card's bf16 tolerance, 2e-2 row-relative."""
    r, k, v, w, u, do, s0, ds = _torch(_inputs(np.random.default_rng(11), 1, 45, 2, 32,
                                               "rwkv", True))
    args = [x.to(torch.bfloat16) for x in (r, k, v)] + [w, u.to(torch.bfloat16),
                                                         do.to(torch.bfloat16), s0, ds]
    got = _bwd_design(*args)
    want = wkv6_backward_plain(*args)
    assert got[0].dtype == torch.bfloat16 and got[4].dtype == torch.bfloat16
    for name, g, wnt in zip(NAMES, got, want):
        assert _row_rel(g, wnt) <= 2e-2, name


def _global_kernels(source):
    src = (ROOT / "src/repro_torch/csrc" / source).read_text()
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(", src)


def test_chip_smoke_fragments_find_every_recurrent_backward_kernel():
    """``chip_smoke.py``'s name fragments for the recurrences' backwards
    (``RECURRENT_BWD_KERNELS``) find every ``__global__`` kernel of their
    sources and no other source's, and each fragment finds one: a renamed
    kernel would otherwise read 0 ms in the traces and CUPTI rows."""
    text = (ROOT / "chip_smoke.py").read_text()
    m = re.search(r"^RECURRENT_BWD_KERNELS = (\{.*?\})$", text, re.M | re.S)
    assert m, "chip_smoke.py defines no RECURRENT_BWD_KERNELS"
    frags = eval(m[1])                                      # a literal dict of tuples
    sources = {"wkv6_bwd": "rwkv6_scan_bwd.cu", "rglru_bwd": "rglru_scan_bwd.cu"}
    assert set(frags) == set(sources)
    others = [n for p in (ROOT / "src/repro_torch/csrc").glob("*.cu")
              if p.name not in sources.values() for n in _global_kernels(p.name)]
    for key, source in sources.items():
        kernels = _global_kernels(source)
        assert len(kernels) >= 2, kernels
        for name in kernels:
            assert any(f in name for f in frags[key]), (name, frags[key])
        for f in frags[key]:
            assert any(f in name for name in kernels), (f, kernels)
            assert not any(f in name for name in others), (f, others)

