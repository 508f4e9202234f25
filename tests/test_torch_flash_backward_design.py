"""The bf16 flash-attention backward kernels' own arithmetic on the CPU,
held against the references.

``csrc/flash_attention_bwd.cu`` runs only on the card; ``chip_smoke.py``
holds it against ``flash_attention_backward_plain`` there.  Here
``_design_bf16`` repeats, in plain PyTorch, what its tensor-core kernels
compute and where they round:

* ``bwd_dq_tc_kernel``, a Q tile of 64 rows at a time: pass 1 walks the
  visible KV tiles of 64 keys and keeps each row's online max, sum and
  Σ e·dP in fp32, in the log2 domain (S·scale·log2(e)), S and dP products
  of the bf16 inputs summed in fp32; it ends with LSE·log2(e) and δ = Σ P·dP.
  Pass 2 rebuilds P = exp2(S·scale·log2(e) − LSE·log2(e)) and
  dS = P ∘ (dP − δ), rounds dS to bf16 and adds dS·K into an fp32 dQ;
* ``bwd_dkdv_tc_kernel``, a KV tile at a time over the G heads of its group
  and the Q tiles that see it: the same P and dS, rounded to bf16 before
  dV += Pᵀ·dO and dK += dSᵀ·Q in fp32;
* the gradients rounded to bf16 once, at the end.

At D = 256 the same arithmetic runs in ``bwd_dq_wg2_kernel`` and
``bwd_dkdv_wg2_kernel`` (two warpgroups a block, D's gradient columns split
between them, which moves no rounding point), and the dkdv kernel splits a
KV head's G query heads over a cluster of GS blocks (``_group_split``, the
kernel's ``group_split``): block g sums heads [G·g/GS, G·(g+1)/GS) into an
fp32 partial, the cluster adds the GS partials in rank order, and each
gradient is rounded once.  ``_design_bf16`` takes GS and repeats that sum.

The model is held within ``ROW_TOL`` = 2e-2 of each gradient row's largest
value (the card's check of the kernel) against ``jax.grad`` of the JAX
package's ``_flash_jnp`` (as ``tests/test_torch_flash_backward.py`` runs it)
and against ``flash_attention_backward_plain``, both on the bf16 inputs'
values in fp32.  One more case pins why δ is that fp32 sum: δ = dO·O of the
output rounded to bf16, as a kernel that read the saved output would take
it, leaves the tolerance in dQ.

A text check keeps ``chip_smoke.py``'s ``BWD_KERNELS`` (the name fragments
by which its traces and CUPTI rows find the backward's kernels) in step
with the ``__global__`` kernels of the source.
"""
import ast
import math
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS_BWD_TC,
    flash_attention_backward_plain,
    flash_attention_plain,
)

ROW_TOL = 2e-2
TILE = 64                       # rows of a Q tile and keys of a KV tile
LOG2E = 1.4426950408889634
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bf16(x):
    return x.to(torch.bfloat16).float()


def _f32(x):
    return torch.tensor(x, dtype=torch.float32)


def _group_split(blocks, G, sms=132):
    """GS of ``csrc/flash_attention_bwd.cu``'s ``group_split``: doubled from
    1 up to min(G, 4) while the dkdv grid (``blocks`` = KV tiles x KV heads x
    batch rows) has fewer than two blocks an SM of the H100."""
    gs = 1
    while 2 * gs <= min(G, 4) and blocks * gs < 2 * sms:
        gs *= 2
    return gs


def _design_bf16(q, k, v, do, *, causal=True, window=None, delta_from=None, gs=1):
    """(dq, dk, dv) in bf16 as the tensor-core kernels compute them from bf16
    q, do (B, S, H, D) and k, v (B, S, Hk, D).  ``delta_from``, if given, is
    the output whose rows' dO·O replace the kernel's δ.  ``gs``: the blocks a
    KV head's group is split over, each summing its heads into an fp32
    partial, the partials added in rank order."""
    B, S, H, D = q.shape
    G = H // k.shape[2]
    qf, dof = q.float(), do.float()
    # head h reads KV head h // G
    kf, vf = (x.float().repeat_interleave(G, dim=2) for x in (k, v))
    scale, scale_log2 = _f32(1.0 / math.sqrt(D)), _f32(LOG2E / math.sqrt(D))
    pos = torch.arange(S)
    vis = pos[None, :] < S
    if causal:
        vis = vis & (pos[None, :] <= pos[:, None])
    if window is not None:
        vis = vis & (pos[None, :] > pos[:, None] - window)
    tiles = [(t, min(t + TILE, S)) for t in range(0, S, TILE)]

    def sees(qt, kt):
        return bool(vis[qt[0]:qt[1], kt[0]:kt[1]].any())

    def scores(qt, kt):
        """S·scale·log2(e) (hidden pairs -inf) and dP, (B, H, rows, keys)."""
        s = torch.einsum("bqhd,bkhd->bhqk", qf[:, qt[0]:qt[1]], kf[:, kt[0]:kt[1]])
        dp = torch.einsum("bqhd,bkhd->bhqk", dof[:, qt[0]:qt[1]], vf[:, kt[0]:kt[1]])
        mask = vis[qt[0]:qt[1], kt[0]:kt[1]]
        return torch.where(mask, s * scale_log2, -torch.inf), dp, mask

    # bwd_dq_tc_kernel, pass 1: LSE·log2(e) and δ of every row
    lse2 = torch.empty(B, H, S)
    delta = torch.empty(B, H, S)
    for qt in tiles:
        m = torch.full((B, H, qt[1] - qt[0]), -torch.inf)
        l, acc = torch.zeros_like(m), torch.zeros_like(m)
        for kt in tiles:
            if not sees(qt, kt):
                continue
            s, dp, _ = scores(qt, kt)
            m_new = torch.maximum(m, s.amax(-1))
            mu = torch.where(m_new == -torch.inf, 0.0, m_new)
            corr = torch.exp2(m - mu)
            e = torch.exp2(s - mu[..., None])
            l = l * corr + e.sum(-1)
            acc = acc * corr + (e * dp).sum(-1)
            m = m_new
        lse2[..., qt[0]:qt[1]] = torch.where(l > 0, m + torch.log2(l), torch.inf)
        delta[..., qt[0]:qt[1]] = torch.where(l > 0, acc / l, 0.0)
    if delta_from is not None:
        delta = torch.einsum("bshd,bshd->bhs", dof, delta_from.float())

    def probs_and_dscores(qt, kt):
        s, dp, mask = scores(qt, kt)
        r = slice(qt[0], qt[1])
        p = torch.where(mask, torch.exp2(s - lse2[..., r, None]), 0.0)
        return p, p * (dp - delta[..., r, None])

    # pass 2: dQ += bf16(dS)·K
    dq = torch.zeros(B, S, H, D)
    for qt in tiles:
        for kt in tiles:
            if sees(qt, kt):
                _, ds = probs_and_dscores(qt, kt)
                dq[:, qt[0]:qt[1]] += torch.einsum("bhqk,bkhd->bqhd", _bf16(ds),
                                                   kf[:, kt[0]:kt[1]])
    # bwd_dkdv_tc_kernel: dV += bf16(P)ᵀ·dO, dK += bf16(dS)ᵀ·Q, then the group's sum
    dk, dv = torch.zeros(B, S, H, D), torch.zeros(B, S, H, D)
    for kt in tiles:
        for qt in tiles:
            if sees(qt, kt):
                p, ds = probs_and_dscores(qt, kt)
                c = slice(kt[0], kt[1])
                dv[:, c] += torch.einsum("bhqk,bqhd->bkhd", _bf16(p), dof[:, qt[0]:qt[1]])
                dk[:, c] += torch.einsum("bhqk,bqhd->bkhd", _bf16(ds), qf[:, qt[0]:qt[1]])
    Hk = k.shape[2]

    def group_sum(x):
        x = x.reshape(B, S, Hk, G, D)
        parts = [x[:, :, :, G * g // gs:G * (g + 1) // gs].sum(3) for g in range(gs)]
        total = parts[0]
        for part in parts[1:]:
            total = total + part
        return total

    return tuple(x.to(torch.bfloat16) for x in (dq * scale, group_sum(dk) * scale, group_sum(dv)))


def _inputs(seed, B, S, H, Hk, D):
    """bf16 q, k, v, dO made from a seed with numpy."""
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(torch.bfloat16)
            for shape in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D), (B, S, H, D))]


def _row_rel(got, want):
    """Max over rows (the last axis) of max|got − want| over the row's
    max|want|, a zero row taken as 1e-6: ``chip_smoke.row_rel_err``."""
    d = (got.float() - want.float()).abs().amax(-1)
    return (d / want.float().abs().amax(-1).clamp(min=1e-6)).max().item()


def _jax_grads(q, k, v, do, window):
    def f(q, k, v):
        out = jops.flash_attention(q, k, v, causal=True, window=window, q_block=64,
                                   kv_block=64, backend="jnp")
        return jnp.sum(out * do)

    grads = jax.jit(jax.grad(f, (0, 1, 2)))(*(x.float().numpy() for x in (q, k, v)))
    return [torch.from_numpy(np.array(g)) for g in grads]


# (D, G, S, window): every head width, group size and length of the card's
# cases but its longest, and one window shorter than S
CASES = [(D, G, S, None) for D in HEAD_DIMS_BWD_TC for G in (1, 2, 4) for S in (1, 37, 128)]
CASES.append((32, 2, 128, 40))


@pytest.mark.parametrize("D,G,S,window", CASES)
def test_design_matches_plain(D, G, S, window):
    q, k, v, do = _inputs(D * 131 + G * 7 + S, 2, S, 4, 4 // G, D)
    gs = _group_split(-(-S // TILE) * (4 // G) * 2, G) if D == 256 else 1
    got = _design_bf16(q, k, v, do, window=window, gs=gs)
    want = flash_attention_backward_plain(*(x.float() for x in (q, k, v, do)), window=window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        rel = _row_rel(g, w)
        assert rel <= ROW_TOL, f"{name}: row-relative {rel:.3g}"


@pytest.mark.parametrize("D,G,S,window", [(16, 1, 37, None), (32, 4, 128, None),
                                          (64, 2, 128, None), (32, 2, 128, 40)])
def test_design_matches_jax_grad(D, G, S, window):
    q, k, v, do = _inputs(D * 131 + G * 7 + S, 2, S, 4, 4 // G, D)
    got = _design_bf16(q, k, v, do, window=window)
    want = _jax_grads(q, k, v, do.float().numpy(), window)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        rel = _row_rel(g, w)
        assert rel <= ROW_TOL, f"{name}: row-relative {rel:.3g}"


# D = 256 at RecurrentGemma's group (16 heads on one KV head) and at G = 1,
# with and without a window shorter than S (ending inside a 64-key tile);
# G = 3 is split 1 + 2 over GS = 2 blocks
D256_CASES = [(G, S, w) for G in (1, 16)
              for S, w in ((1, None), (37, None), (37, 20), (130, None), (130, 50))]
D256_CASES.append((3, 130, 50))


@pytest.mark.parametrize("G,S,window", D256_CASES)
def test_d256_design_matches_plain_and_jax_grad(G, S, window):
    H = 6 if G == 3 else 16
    q, k, v, do = _inputs(G * 7 + S + (window or 0), 1, S, H, H // G, 256)
    gs = _group_split(-(-S // TILE) * (H // G), G)
    assert gs == {1: 1, 3: 2, 16: 4}[G]
    got = _design_bf16(q, k, v, do, window=window, gs=gs)
    plain = flash_attention_backward_plain(*(x.float() for x in (q, k, v, do)), window=window)
    grads = _jax_grads(q, k, v, do.float().numpy(), window)
    for name, g, p, j in zip(("dq", "dk", "dv"), got, plain, grads):
        assert g.dtype == torch.bfloat16
        for ref, want in (("plain", p), ("jax.grad", j)):
            rel = _row_rel(g, want)
            assert rel <= ROW_TOL, f"{name} against {ref}: row-relative {rel:.3g}"


def test_delta_from_a_bf16_output_leaves_the_tolerance():
    """δ = dO·O with O rounded to bf16 (the saved output) moves dQ past the
    tolerance where the kernel's fp32 Σ P·dP stays inside it."""
    q, k, v, do = _inputs(11, 1, 256, 4, 4, 64)
    want = flash_attention_backward_plain(*(x.float() for x in (q, k, v, do)))
    out = flash_attention_plain(*(x.float() for x in (q, k, v)))
    kernel = _design_bf16(q, k, v, do)
    from_out = _design_bf16(q, k, v, do, delta_from=out.to(torch.bfloat16))
    assert _row_rel(kernel[0], want[0]) <= ROW_TOL
    assert _row_rel(from_out[0], want[0]) > ROW_TOL
    # dV does not read δ
    assert torch.equal(kernel[2], from_out[2])


def _bwd_kernel_fragments():
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    for node in tree.body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == "BWD_KERNELS" for t in node.targets):
            return ast.literal_eval(node.value)
    raise AssertionError("chip_smoke.py defines no BWD_KERNELS")


def test_chip_smoke_names_every_backward_kernel():
    """Each ``__global__`` kernel of the source is found by a fragment of
    ``BWD_KERNELS``, and each fragment finds a kernel: a renamed kernel
    would otherwise read 0 ms in the traces and CUPTI rows."""
    src = (ROOT / "src/repro_torch/csrc/flash_attention_bwd.cu").read_text()
    kernels = re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s*)?(\w+)\s*\(",
                         src)
    frags = _bwd_kernel_fragments()
    assert len(kernels) == 8, kernels
    for name in kernels:
        assert any(f in name for f in frags), (name, frags)
    for f in frags:
        assert any(f in name for name in kernels), (f, kernels)
