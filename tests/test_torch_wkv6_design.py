"""The WKV6 kernel's own arithmetic on the CPU, held against the references.

``csrc/rwkv6_scan.cu`` runs only on the card; ``chip_smoke.py`` holds it
against ``wkv6_plain`` there.  Here ``_prefill_design`` and ``_step_design``
repeat, in plain fp32 PyTorch, what its kernels compute and in which order:

* prefill (T > 1), one block per chunk of 32 tokens taken in ticket order
  (chunk-major), each block first computing what does not need the
  incoming state (the log-decay sums over groups of four tokens, the pair
  scores, the bonus terms, the decayed r and k, ΔS and e^{LC}), then
  taking the incoming state from its (row, head)'s slot, writing
  e^{LC} · S + ΔS to the other slot (or the final state) and adding the
  state, intra-chunk and bonus terms of its outputs in that order;
* the step (T == 1): o = r S + (Σ r u k) v, S' = exp(log(clamp(w))) S + k v.

Every exponent of the prefill is a sum of log-decays of one sign, never a
difference of two cumulative sums that run to hundreds, so the model
agrees with ``wkv6_plain`` (float64 throughout, rounded once) at
``PLAIN_TOL`` = 2e-5, the card's own check of the kernel against the plain
version.  It is held against the JAX package's ``_wkv6_jnp``, both
token-by-token oracles and, where its ±30 clip never engages,
``wkv6_pallas`` in interpret mode at ``WKV_TOL`` = 2e-4, as
``tests/test_torch_kernels.py`` holds the chunked forms to the oracle.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.rwkv6_scan import wkv6_pallas
from repro_torch.kernels import ref
from repro_torch.kernels.rwkv6_scan import CHUNK, wkv6_plain


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


WKV_TOL = 2e-4
PLAIN_TOL = 2e-5
C = CHUNK


def _log_decay(w):
    return torch.log(w.clamp(1e-12, 1.0))


def _group_sums(lw):
    """The kernel's log-decay sums for one chunk's logs ``lw`` (C, D), in
    its order, fp32, every one a sum of terms of one sign: A[t] over the
    tokens of t's group of four before t, B[t] over those after t, P[g]
    over the groups before g, Q[g] over those after g, G[ti][sj] over the
    groups strictly between sj and ti, and the chunk's total."""
    n_g = C // 4
    A, B = torch.empty_like(lw), torch.empty_like(lw)
    tot = []
    for g in range(n_g):
        a = torch.zeros(lw.shape[1])
        for i in range(4):
            A[4 * g + i] = a
            a = a + lw[4 * g + i]
        tot.append(a)
        b = torch.zeros(lw.shape[1])
        for i in reversed(range(4)):
            B[4 * g + i] = b
            b = b + lw[4 * g + i]
    P, Q, p, q = [None] * n_g, [None] * n_g, torch.zeros(lw.shape[1]), torch.zeros(lw.shape[1])
    for g in range(n_g):
        P[g] = p
        p = p + tot[g]
    for g in reversed(range(n_g)):
        Q[g] = q
        q = q + tot[g]
    G = {}
    for ti in range(1, n_g):
        acc = torch.zeros(lw.shape[1])
        for sj in reversed(range(ti)):
            G[ti, sj] = acc
            acc = acc + tot[sj]
    return A, B, P, Q, G, p


def _prefill_design(r, k, v, w, u, state):
    """The prefill kernel's arithmetic: returns (out, final state), fp32.
    Blocks take chunks in the order of an atomic ticket, chunk-major; the
    model walks the tickets in that order and asserts that each block's
    predecessor has published, which is what lets the kernel's waits end."""
    B, T, H, D = r.shape
    n_chunks = -(-T // C)
    BH = B * H
    pad = n_chunks * C - T
    r_, k_, v_ = (torch.nn.functional.pad(x.float(), (0, 0, 0, 0, 0, pad)) for x in (r, k, v))
    lw_all = torch.nn.functional.pad(_log_decay(w.float()), (0, 0, 0, 0, 0, pad))   # w = 1
    u32 = u.float()
    slots = torch.zeros((B, H, 2, D, D))
    flags = torch.zeros(BH, dtype=torch.int64)
    final = torch.empty((B, H, D, D))
    out = torch.empty((B, n_chunks * C, H, D))
    for ticket in range(n_chunks * BH):             # chunk-major tickets
        c, bh = divmod(ticket, BH)
        b, h = divmod(bh, H)
        sl = slice(c * C, (c + 1) * C)
        rc, kc, vc, lw = r_[b, sl, h], k_[b, sl, h], v_[b, sl, h], lw_all[b, sl, h]   # (C, D)
        A, Bs, P, Q, G, LC = _group_sums(lw)
        # pair scores (s < t) and bonus terms (s = t): the exponent of a pair
        # in one group is the sum of the logs strictly between s and t,
        # else A[t] + G + B[s]
        att = torch.zeros((C, C))
        for t in range(C):
            for s in range(t):
                ti, sj = t // 4, s // 4
                if ti == sj:
                    e = torch.zeros(D)
                    for j in range(s + 1, t):
                        e = e + lw[j]
                else:
                    e = (A[t] + G[ti, sj]) + Bs[s]
                att[t, s] = (rc[t] * torch.exp(e) * kc[s]).sum()
        bonus = (rc * u32[h] * kc).sum(dim=1)
        g_of = torch.arange(C) // 4
        q = rc * torch.exp(torch.stack([P[g] for g in g_of.tolist()]) + A)
        kd = kc * torch.exp(Bs + torch.stack([Q[g] for g in g_of.tolist()]))
        dS = kd.T @ vc
        e_lc = torch.exp(LC)
        # the chain step: the predecessor, a smaller ticket, has published
        assert c == 0 or flags[bh] == c
        S_in = state[b, h].float() if c == 0 else slots[b, h, c % 2].clone()
        S_out = e_lc[:, None] * S_in + dS
        if c + 1 == n_chunks:
            final[b, h] = S_out
        else:
            slots[b, h, (c + 1) % 2] = S_out
            flags[bh] = c + 1
        out[b, sl, h] = (q @ S_in + att @ vc) + bonus[:, None] * vc
    assert bool((flags == max(n_chunks - 1, 0)).all())
    return out[:, :T], final


def _step_design(r, k, v, w, u, state):
    """The step kernel's arithmetic (T == 1)."""
    r_, k_, v_ = (x[:, 0].float() for x in (r, k, v))                # (B, H, D)
    S = state.float()
    bonus = (r_ * u.float() * k_).sum(dim=-1)                        # (B, H)
    out = torch.einsum("bhd,bhde->bhe", r_, S) + bonus[..., None] * v_
    w_dec = torch.exp(_log_decay(w[:, 0].float()))
    S_new = w_dec[..., None] * S + k_[..., :, None] * v_[..., None, :]
    return out[:, None], S_new


def _design(r, k, v, w, u, state):
    if r.shape[1] == 1:
        return _step_design(r, k, v, w, u, state)
    return _prefill_design(r, k, v, w, u, state)


def _inputs(rng, B, T, H, D, decay):
    """r/k/v ~ N(0, 1), u ~ U(−0.5, 0.5), a carried state, and decays:
    ``rwkv`` RWKV6's own init exp(−exp(U(−0.5, 0.5))), ``mild`` U(0.4, 0.999)
    (where ``wkv6_pallas``'s clip never engages), ``tiny`` U(1e-12, 1) with a
    sixteenth set to 1e-12, or ``wide`` exp(−exp(U(−6, 3.32))), from 0.998
    down to 1e-12 with as many near 1 as near 1e-12."""
    r, k, v = (rng.normal(size=(B, T, H, D)).astype(np.float32) for _ in range(3))
    if decay == "rwkv":
        w = np.exp(-np.exp(rng.uniform(-0.5, 0.5, (B, T, H, D))))
    elif decay == "mild":
        w = rng.uniform(0.4, 0.999, (B, T, H, D))
    elif decay == "wide":
        w = np.exp(-np.exp(rng.uniform(-6.0, 3.32, (B, T, H, D))))
    else:
        w = np.clip(rng.uniform(0.0, 1.0, (B, T, H, D)), 1e-12, 1.0)
        w[rng.uniform(size=(B, T, H, D)) < 1 / 16] = 1e-12
    u = rng.uniform(-0.5, 0.5, (H, D)).astype(np.float32)
    s0 = (0.3 * rng.normal(size=(B, H, D, D))).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, s0


def _close(got, want, tol):
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32), atol=tol, rtol=tol)


@pytest.mark.parametrize("decay", ["rwkv", "tiny", "wide"])
@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("T", [1, 31, 32, 33, 65, 97])
def test_design_matches_plain_jax_and_oracles(T, D, decay):
    rng = np.random.default_rng(100 * T + D + len(decay))
    arrs = _inputs(rng, 2, T, 2, D, decay)
    out, s_t = _design(*(torch.from_numpy(a) for a in arrs))
    plain_out, plain_s = wkv6_plain(*(torch.from_numpy(a) for a in arrs))
    _close(out, plain_out, PLAIN_TOL)
    _close(s_t, plain_s, PLAIN_TOL)
    j = [jnp.asarray(a) for a in arrs]
    for want_out, want_s in (jops._wkv6_jnp(*j, C), jref.wkv6_ref(*j),
                             ref.wkv6_ref(*(torch.from_numpy(a) for a in arrs))):
        _close(out, want_out, WKV_TOL)
        _close(s_t, want_s, WKV_TOL)


def _oracle64(r, k, v, w, u, state):
    """The recurrence token by token in float64: the exact result to well
    below fp32 rounding."""
    S = state.double()
    r, k, v, w, u = (x.double() for x in (r, k, v, w, u))
    outs = []
    for t in range(r.shape[1]):
        kv = k[:, t, :, :, None] * v[:, t, :, None, :]
        outs.append(torch.einsum("bhd,bhde->bhe", r[:, t], S + u[None, :, :, None] * kv))
        S = w[:, t, :, :, None] * S + kv
    return torch.stack(outs, dim=1), S


@pytest.mark.parametrize("decay", ["tiny", "wide"])
@pytest.mark.parametrize("T", [65, 97])
def test_design_and_plain_are_within_fp32_error_of_the_exact_result(T, decay):
    """With decays down to 1e-12 beside decays near 1 in one chunk, the
    log-decay sums run to hundreds; a pair exponent taken as a difference
    of two fp32 cumulative sums there lost ~1e-4.  The kernel's sums of one
    sign and the plain version's float64 stay within 2e-5 of the exact
    result."""
    rng = np.random.default_rng(3 * T + len(decay))
    arrs = [torch.from_numpy(a) for a in _inputs(rng, 2, T, 3, 32, decay)]
    want_out, want_s = _oracle64(*arrs)
    for got_out, got_s in (_design(*arrs), wkv6_plain(*arrs)):
        _close(got_out, want_out, PLAIN_TOL)
        _close(got_s, want_s, PLAIN_TOL)


@pytest.mark.parametrize("D", [16, 32])
@pytest.mark.parametrize("T", [1, 33, 65])
def test_design_matches_pallas_in_the_mild_range(T, D):
    """Where the TPU kernel's ±30 clip never engages, it agrees too."""
    rng = np.random.default_rng(7 * T + D)
    arrs = _inputs(rng, 2, T, 2, D, "mild")
    out, s_t = _design(*(torch.from_numpy(a) for a in arrs))
    want_out, want_s = wkv6_pallas(*(jnp.asarray(a) for a in arrs), chunk=C, interpret=True)
    _close(out, want_out, WKV_TOL)
    _close(s_t, want_s, WKV_TOL)


def test_step_is_the_prefill_of_one_token():
    """At T == 1 the step's update is what the padded chunk of the plain
    version and of the prefill design give: e^{LC} = w', k_dec = k."""
    rng = np.random.default_rng(5)
    arrs = [torch.from_numpy(a) for a in _inputs(rng, 3, 1, 2, 32, "tiny")]
    step_out, step_s = _step_design(*arrs)
    chunk_out, chunk_s = _prefill_design(*arrs)
    torch.testing.assert_close(step_out, chunk_out, atol=PLAIN_TOL, rtol=PLAIN_TOL)
    torch.testing.assert_close(step_s, chunk_s, atol=0.0, rtol=0.0)
    plain_out, plain_s = wkv6_plain(*arrs)
    _close(step_out, plain_out, PLAIN_TOL)
    _close(step_s, plain_s, PLAIN_TOL)


def test_bfloat16_inputs_round_the_output_only():
    """bf16 r/k/v/u: the design's output rounded once to bf16 is the plain
    version's bf16 output within one bf16 step; the state stays fp32."""
    rng = np.random.default_rng(11)
    r, k, v, w, u, s0 = (torch.from_numpy(a) for a in _inputs(rng, 1, 45, 2, 32, "rwkv"))
    rb, kb, vb, ub = (x.to(torch.bfloat16) for x in (r, k, v, u))
    out, s_t = _design(rb, kb, vb, w, ub, s0)
    plain_out, plain_s = wkv6_plain(rb, kb, vb, w, ub, s0)
    assert plain_out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.to(torch.bfloat16).float().numpy(), plain_out.float().numpy(),
                               atol=2e-2, rtol=2e-2)
    _close(s_t, plain_s, PLAIN_TOL)


def _criterion(got, want):
    """The smallest tol at which ``_close(got, want, tol)`` holds (atol =
    rtol = tol): max |got − want| / (1 + |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.max(np.abs(got - want) / (1 + np.abs(want))))


def test_wkv6_jnp_pair_exponent_fault_is_pinned():
    """A fault of the reference: ``_wkv6_jnp`` takes each pair decay as
    ``exp(L_excl[t] − L[s])``, a difference of fp32 cumulative sums of the
    log-decays (``src/repro/kernels/ops.py:286-296``).  With decays near 1
    beside 1e-12 in one chunk (``wide``) those sums run to hundreds, and at
    RWKV6-3B's head width (D=64, 4 heads, 64 tokens, seed 6) its output
    leaves the oracle's 2e-4 (2.6e-4 from ``wkv6_ref`` and from the float64
    oracle), while ``wkv6_ref`` stays within 1e-5 of the float64 oracle and
    the port's plain version within 2e-5.  The port follows the oracles."""
    arrs = _inputs(np.random.default_rng(6), 1, 64, 4, 64, "wide")
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.from_numpy(a) for a in arrs]
    jnp_out, _ = jops._wkv6_jnp(*j, C)
    ref_out, _ = jref.wkv6_ref(*j)
    exact_out, _ = _oracle64(*t)
    plain_out, _ = wkv6_plain(*t)
    assert _criterion(jnp_out, ref_out) > WKV_TOL
    assert _criterion(jnp_out, exact_out.numpy()) > WKV_TOL
    assert _criterion(ref_out, exact_out.numpy()) < 1e-5
    assert _criterion(plain_out.numpy(), exact_out.numpy()) < PLAIN_TOL
