"""The flash-attention backward of the port on the CPU: its plain version and
the autograd of ``ops.flash_attention`` (through ``FlashAttention``) held
against ``jax.grad`` of the JAX package's tiled ``_flash_jnp``
(``ops.flash_attention(..., backend="jnp")``) and of its naive oracle
``mha_ref``, on the same numpy-seeded inputs and output gradient.

Float32 gradients are held within 1e-5 absolute (inputs and gradients are
of order one; the two frameworks sum in other orders, a few 1e-7 apart).
The bfloat16 case rounds the inputs and the gradients to bf16 and is held
within 2e-2 of each row's largest gradient, as the kernels' bf16 checks
are.  The CUDA kernel itself runs only on the card, where ``chip_smoke.py``
holds it against ``flash_attention_backward_plain``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.ref import mha_ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (
    HEAD_DIMS_BWD,
    FlashAttention,
    flash_attention_backward_cuda,
    flash_attention_backward_plain,
    flash_attention_plain,
)

ATOL = 1e-5
BF16_ROW_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(seed, B, S, H, Hk, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, Hk, D), (B, S, Hk, D), (B, S, H, D))]


def _jax_grads(fn, q, k, v, do):
    return jax.jit(jax.grad(lambda q, k, v: jnp.sum(fn(q, k, v) * do), (0, 1, 2)))(q, k, v)


# (B, S, H, Hk, D, window, q_block, kv_block): G in {1, 2, 4}, S not a
# multiple of the tiles, windows shorter than S, S = 1
CASES = [
    (2, 37, 4, 4, 32, None, 16, 16),
    (2, 37, 4, 2, 16, None, 16, 8),
    (1, 70, 8, 2, 32, 24, 32, 16),
    (1, 130, 4, 1, 64, 50, 64, 32),
    (2, 45, 8, 2, 32, 1, 16, 16),
    (2, 1, 4, 1, 32, None, 16, 16),
    (1, 64, 4, 1, 16, None, 512, 1024),
]


@pytest.mark.parametrize("B,S,H,Hk,D,win,qb,kb", CASES)
def test_backward_matches_jax_grad(B, S, H, Hk, D, win, qb, kb):
    q, k, v, do = _inputs(S * 7 + H, B, S, H, Hk, D)
    tiled = _jax_grads(lambda q, k, v: jops.flash_attention(
        q, k, v, causal=True, window=win, q_block=qb, kv_block=kb, backend="jnp"), q, k, v, do)
    naive = _jax_grads(lambda q, k, v: mha_ref(q, k, v, causal=True, window=win), q, k, v, do)

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = ops.flash_attention(tq, tk, tv, causal=True, window=win, q_block=qb, kv_block=kb)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    out.backward(torch.from_numpy(do))
    auto = (tq.grad, tk.grad, tv.grad)
    plain = flash_attention_backward_plain(
        tq.detach(), tk.detach(), tv.detach(), torch.from_numpy(do),
        causal=True, window=win, q_block=qb, kv_block=kb)
    for name, a, p, j_tiled, j_naive in zip("qkv", auto, plain, tiled, naive):
        for got in (a, p):
            for want in (j_tiled, j_naive):
                err = np.abs(got.numpy() - np.asarray(want)).max()
                assert err <= ATOL, f"d{name}: {err:.3g}"
        # the autograd node runs the plain backward itself
        np.testing.assert_array_equal(a.numpy(), p.numpy())


def test_backward_bf16_within_row_tolerance():
    B, S, H, Hk, D = 2, 77, 8, 2, 32
    q, k, v, do = (torch.from_numpy(x).to(torch.bfloat16) for x in _inputs(5, B, S, H, Hk, D))
    want = _jax_grads(lambda q, k, v: mha_ref(q, k, v, causal=True, window=40),
                      *(x.float().numpy() for x in (q, k, v, do)))
    want = [np.array(w) for w in want]
    leaves = [x.clone().requires_grad_() for x in (q, k, v)]
    out = ops.flash_attention(*leaves, causal=True, window=40, q_block=32, kv_block=16)
    out.backward(do)
    for x, w in zip(leaves, want):
        assert x.grad.dtype == torch.bfloat16
        w = torch.from_numpy(w)
        d = (x.grad.float() - w).abs().amax(-1)
        rel = (d / w.abs().amax(-1).clamp(min=1e-2)).max().item()
        assert rel <= BF16_ROW_TOL, rel


def test_plain_backward_over_uneven_offsets_and_no_window():
    """Sq < Skv (ends aligned, as the plain forward takes them) and a
    non-causal call: the plain backward against autograd through the plain
    forward's own arithmetic."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((1, 21, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((1, 21, 2, 16)).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((1, 9, 4, 16)).astype(np.float32))
    for causal, win in ((True, None), (True, 5), (False, None)):
        leaves = [x.clone().requires_grad_() for x in (q, k, v)]
        out = flash_attention_plain(*leaves, causal=causal, window=win, q_block=4, kv_block=8)
        out.backward(do)
        got = flash_attention_backward_plain(q, k, v, do, causal=causal, window=win,
                                             q_block=4, kv_block=8)
        for x, g in zip(leaves, got):
            assert (x.grad - g).abs().max().item() <= ATOL


def test_no_autograd_node_under_no_grad():
    """Serving paths run under ``no_grad``: ``ops.flash_attention`` must call
    the forward directly there, and with no input requiring grad."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(1, 1, 8, 2, 2, 16))
    with torch.no_grad():
        out = ops.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None and not out.requires_grad
    q.requires_grad_(False)
    assert ops.flash_attention(q, k, v).grad_fn is None
    calls = []
    orig = FlashAttention.apply
    FlashAttention.apply = staticmethod(lambda *a: calls.append(1) or orig(*a))
    try:
        with torch.no_grad():
            ops.flash_attention(q.clone().requires_grad_(), k, v)
        assert not calls
        ops.flash_attention(q.clone().requires_grad_(), k, v)
        assert calls == [1]
    finally:
        del FlashAttention.apply


def test_cuda_wrapper_refuses_cpu_tensors_and_wide_heads():
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(2, 1, 4, 2, 2, 16))
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_backward_cuda(q, k, v, do)
    assert HEAD_DIMS_BWD == (16, 32, 64, 256)
    assert flash_attention_backward_cuda.launches == 0
