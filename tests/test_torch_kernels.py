"""The port's attention kernels on the CPU: their plain PyTorch versions held
against the JAX package's tiled versions and Pallas kernels (interpret mode),
and the device dispatch of the wrappers.

The CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds
each against its plain version there.  Tolerances are those of
``tests/test_kernels.py``: 2e-5 in float32 (summation order differs between
the frameworks), 2e-2 in bfloat16 (one bf16 rounding of the output).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_pallas
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels.flash_attention import flash_attention_cuda, flash_attention_plain
from repro_torch.kernels.paged_attention import paged_attention_cuda, paged_attention_plain

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
# dispatch: a CPU tensor takes the plain version; the kernel needs the card
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(5)
    (q, _), (k, _), (v, _) = _arrs(rng, "float32", (1, 32, 4, 16), (1, 32, 2, 16),
                                   (1, 32, 2, 16))
    f0, p0 = flash_attention_cuda.launches, paged_attention_cuda.launches
    assert torch.equal(ops.flash_attention(q, k, v, q_block=16, kv_block=16),
                       flash_attention_plain(q, k, v, q_block=16, kv_block=16))
    pool = k.reshape(2, 16, 2, 16)
    table = torch.tensor([[0, 1]], dtype=torch.int32)
    lengths = torch.tensor([20], dtype=torch.int32)
    assert torch.equal(ops.paged_attention(q[:, :1], pool, pool, table, lengths),
                       paged_attention_plain(q[:, :1], pool, pool, table, lengths))
    assert (flash_attention_cuda.launches, paged_attention_cuda.launches) == (f0, p0)


def test_kernel_wrappers_refuse_cpu_tensors():
    q = torch.zeros(1, 16, 2, 16)
    with pytest.raises(ValueError, match="not a CUDA device"):
        flash_attention_cuda(q, q, q)
    table = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(ValueError, match="not a CUDA device"):
        paged_attention_cuda(q[:, :1], q, q, table, torch.ones(1, dtype=torch.int32))


def test_kernel_build_raises_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "NVCC_FALLBACK", str(tmp_path / "no-nvcc"))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(build, "_loaded", {})
    for name in build.SOURCES:
        with pytest.raises(RuntimeError, match="nvcc"):
            build.load(name)
    assert not (tmp_path / "build").exists()
