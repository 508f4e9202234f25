"""The port's models against the JAX package's, on the CPU: the dense
decoder (paged and contiguous decode) and RWKV6 (prefill and decode on the
recurrent state).

Weights come from the JAX ``Model.init`` and cross through the weight bridge;
inputs are made with numpy from fixed seeds.  Prefill and ``decode_step``
logits, and the caches they leave, must agree within 1e-4 (absolute and
relative) in float32: the two frameworks sum in different orders, which
moves float32 results by ~1e-6, and 1e-4 leaves room for two layers of that.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.models.transformer import Model as JaxModel
from repro_torch.config import get_arch
from repro_torch.models.bridge import load_npz, state_from_jax
from repro_torch.models.transformer import Model
from repro_torch.serving.graphs import RecurrentDecoder


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Run the port on one torch thread: the suite's workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-4

ARCHS = [("tiny-s", False), ("qwen1.5-0.5b", True), ("rwkv6-3b", True)]  # (arch, reduced())
DENSE = ARCHS[:2]


def _cfgs(arch, reduced):
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    if reduced:
        jcfg, cfg = jcfg.reduced(), cfg.reduced()
    return jcfg, cfg


def _pair(arch, reduced, seed=0):
    jcfg, cfg = _cfgs(arch, reduced)
    jmodel = JaxModel(jcfg, JaxShardingConfig(remat="none"))
    jparams = jmodel.init(jax.random.PRNGKey(seed))
    model = Model(cfg, device="cpu")
    model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), cfg))
    return jmodel, jparams, model


@pytest.mark.parametrize("arch,reduced", ARCHS)
def test_config_copy_matches_reference(arch, reduced):
    jcfg, cfg = _cfgs(arch, reduced)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("arch", [a for a, _ in ARCHS])
def test_full_config_copy_matches_reference(arch):
    jcfg, cfg = _cfgs(arch, False)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert cfg.param_count() == jcfg.param_count()


def test_full_width_rwkv_shapes():
    cfg = get_arch("rwkv6-3b")
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.d_model // cfg.rwkv_head_dim,
            cfg.rwkv_head_dim, cfg.d_ff, cfg.vocab_size, cfg.norm, cfg.rope_type,
            cfg.dtype) == ("ssm", 32, 2560, 40, 64, 8960, 65_536, "layernorm", "none",
                           "bfloat16")
    assert 3.0e9 < cfg.param_count() < 3.2e9


def test_full_width_qwen_shapes():
    cfg = get_arch("qwen1.5-0.5b")
    assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim,
            cfg.d_ff, cfg.vocab_size, cfg.qkv_bias, cfg.rope_theta, cfg.dtype) == \
        (24, 1024, 16, 16, 64, 2816, 151_936, True, 1e6, "bfloat16")


@pytest.mark.parametrize("arch,reduced", ARCHS)
def test_bridge_round_trip(arch, reduced, tmp_path):
    """Every JAX leaf lands unchanged in the port (layer i of a stacked leaf
    in block i, (d_in, d_out) layout kept), through the nested tree and
    through a ``save_pytree`` checkpoint alike."""
    from repro.checkpoint.ckpt import save_pytree

    _, jparams, model = _pair(arch, reduced)
    state = model.state_dict()
    flat = {k.replace("/", "."): np.asarray(v) for k, v in
            {"/".join(str(p.key) for p in path): leaf for path, leaf in
             jax.tree_util.tree_flatten_with_path(jparams)[0]}.items()}
    n_stacked = 0
    for key, arr in flat.items():
        if key.startswith("blocks.b0."):
            leaf = key[len("blocks.b0."):]
            for i in range(model.cfg.n_layers):
                np.testing.assert_array_equal(state[f"blocks.{i}.{leaf}"].numpy(), arr[i])
            n_stacked += model.cfg.n_layers
        else:
            np.testing.assert_array_equal(state[key].numpy(), arr)
    assert n_stacked + (len(flat) - sum(k.startswith("blocks.b0.") for k in flat)) == len(state)
    assert state["embed"].shape[0] % 32 == 0 and state["lm_head"].shape[1] % 32 == 0

    path = save_pytree(jparams, str(tmp_path), step=0)
    from_npz = state_from_jax(load_npz(f"{path}/arrays.npz"), model.cfg)
    assert from_npz.keys() == state.keys()
    for k, v in from_npz.items():
        assert torch.equal(v, state[k]), k


def test_bridge_carries_bfloat16_bits():
    import ml_dtypes

    a = np.asarray([[1.5, -2.25], [3.0e-3, 7.0]], dtype=ml_dtypes.bfloat16)
    cfg = get_arch("tiny-s")
    state = state_from_jax({"embed": a}, cfg)
    assert state["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(state["embed"].float().numpy(), a.astype(np.float32))


@pytest.mark.parametrize("arch,reduced", DENSE)
def test_prefill_logits_match_reference(arch, reduced):
    jmodel, jparams, model = _pair(arch, reduced)
    rng = np.random.default_rng(1)
    B, S = 3, 24
    tokens = rng.integers(0, 259, (B, S)).astype(np.int32)
    lengths = np.asarray([S, 7, 16], np.int32)
    want, jcache = jmodel.prefill(jparams, jax.numpy.asarray(tokens), S,
                                  lengths=jax.numpy.asarray(lengths))
    got, rows = model.prefill(torch.from_numpy(tokens), lengths=torch.from_numpy(lengths))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    # the cache rows are the rotated K and the V of every layer
    for name in ("k", "v"):
        np.testing.assert_allclose(rows[name].numpy(),
                                   np.asarray(jcache["blocks"]["b0"][name]),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(rows["len"].numpy(), lengths)


@pytest.mark.parametrize("arch,reduced", DENSE)
def test_paged_decode_step_matches_reference(arch, reduced):
    """Three paged decode steps from the same pools and block table: live
    rows' logits match, and so do the pools the steps wrote into.  Row 3 is
    a retired slot (all-sentinel table, stale length): JAX drops its write
    and the port routes it to the drop page; its logits only need be
    finite."""
    jmodel, jparams, model = _pair(arch, reduced)
    cfg = model.cfg
    rng = np.random.default_rng(2)
    B, ps, n_cols, P = 4, 8, 4, 18
    L, Hk, hd = cfg.n_layers, cfg.n_kv_heads, cfg.head_dim
    pools = rng.normal(size=(2, L, P, ps, Hk, hd)).astype(np.float32)
    phys = rng.permutation(P)[:B * n_cols].reshape(B, n_cols)
    lengths = np.asarray([5, 17, 9, 21], np.int32)
    # map the pages the next three steps touch; leave the rest unmapped
    table = np.where(np.arange(n_cols)[None] * ps < (lengths + 3)[:, None], phys, P)
    table[3] = P                                            # retired slot
    table = table.astype(np.int32)

    jcache = {"blocks": {"b0": {"k": jax.numpy.asarray(pools[0]),
                                "v": jax.numpy.asarray(pools[1]),
                                "len": jax.numpy.asarray(np.tile(lengths, (L, 1)))}}}
    cache = model.init_paged_cache(P, ps, B)
    cache["k"][:, :P] = torch.from_numpy(pools[0])
    cache["v"][:, :P] = torch.from_numpy(pools[1])
    cache["len"][:] = torch.from_numpy(lengths)
    live = [0, 1, 2]
    for step in range(3):
        tokens = rng.integers(0, 259, (B, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jax.numpy.asarray(tokens), jcache,
                                          table=jax.numpy.asarray(table))
        got = model.decode_step(torch.from_numpy(tokens), cache, torch.from_numpy(table))
        np.testing.assert_allclose(got[live].numpy(), np.asarray(want)[live],
                                   atol=TOL, rtol=TOL, err_msg=f"step {step}")
        assert torch.isfinite(got[3]).all()
        np.testing.assert_array_equal(cache["len"].numpy(), lengths + step + 1)
    for i, name in enumerate(("k", "v")):
        np.testing.assert_allclose(cache[name][:, :P].numpy(),
                                   np.asarray(jcache["blocks"]["b0"][name]),
                                   atol=TOL, rtol=TOL)


def test_init_follows_builder_scheme():
    cfg = get_arch("qwen1.5-0.5b").reduced()
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    blk = model.blocks[0]
    assert torch.equal(blk.n1.scale, torch.ones_like(blk.n1.scale))
    assert torch.equal(blk.attn.q.b, torch.zeros_like(blk.attn.q.b))
    w = blk.mlp.down.w                                     # (d_ff, d): fan_in d_ff
    assert abs(w.std().item() * np.sqrt(cfg.d_ff) - 1.0) < 0.05
    again = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    for a, b in zip(model.parameters(), again.parameters()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,reduced", DENSE)
def test_contiguous_decode_step_matches_reference(arch, reduced):
    """Prefill into a contiguous cache of ``max_len`` positions, then three
    decode steps: logits and the caches match the JAX model's.  Row 0
    starts two positions short of ``max_len``, so its third write falls
    past the buffer: JAX drops it, the port leaves the cache as it was,
    and both attend the full buffer."""
    jmodel, jparams, model = _pair(arch, reduced)
    rng = np.random.default_rng(4)
    B, S, max_len = 3, 24, 26
    tokens = rng.integers(0, 259, (B, S)).astype(np.int32)
    lengths = np.asarray([S, 7, 16], np.int32)
    want, jcache = jmodel.prefill(jparams, jax.numpy.asarray(tokens), max_len,
                                  lengths=jax.numpy.asarray(lengths))
    got, cache = model.prefill(torch.from_numpy(tokens), lengths=torch.from_numpy(lengths),
                               max_len=max_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    assert cache["k"].shape[2] == max_len
    for step in range(3):
        tok = rng.integers(0, 259, (B, 1)).astype(np.int32)
        want, jcache = jmodel.decode_step(jparams, jax.numpy.asarray(tok), jcache)
        got = model.decode_step(torch.from_numpy(tok), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=f"step {step}")
    for name in ("k", "v"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache["blocks"]["b0"][name]),
                                   atol=TOL, rtol=TOL)
    np.testing.assert_array_equal(cache["len"].numpy(),
                                  np.asarray(jcache["blocks"]["b0"]["len"])[0])


def _rwkv_cache_close(cache, jcache):
    for name in ("shift_tm", "shift_cm", "wkv"):
        np.testing.assert_allclose(cache[name].numpy(), np.asarray(jcache["blocks"]["b0"][name]),
                                   atol=TOL, rtol=TOL, err_msg=name)


def test_rwkv_prefill_matches_reference():
    """Logits and the recurrent cache (token-shift and WKV states of every
    layer) after a 45-token prompt — one full chunk of 32 and a ragged one."""
    jmodel, jparams, model = _pair("rwkv6-3b", True)
    tokens = np.random.default_rng(5).integers(0, 512, (2, 45)).astype(np.int32)
    want, jcache = jmodel.prefill(jparams, jax.numpy.asarray(tokens), 45)
    got, cache = model.prefill(torch.from_numpy(tokens))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL)
    _rwkv_cache_close(cache, jcache)
    assert cache["wkv"].dtype == torch.float32
    with pytest.raises(ValueError, match="attention-only"):
        model.prefill(torch.from_numpy(tokens), lengths=torch.tensor([45, 30]))


def test_rwkv_decode_steps_match_reference():
    """Four greedy ``decode_step``s from the prefill state: logits and the
    recurrent cache match at every step."""
    jmodel, jparams, model = _pair("rwkv6-3b", True)
    tokens = np.random.default_rng(6).integers(0, 512, (3, 20)).astype(np.int32)
    want, jcache = jmodel.prefill(jparams, jax.numpy.asarray(tokens), 20)
    got, cache = model.prefill(torch.from_numpy(tokens))
    for step in range(4):
        tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
        want, jcache = jmodel.decode_step(jparams, jax.numpy.asarray(tok), jcache)
        got = model.decode_step(torch.from_numpy(tok), cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL, rtol=TOL,
                                   err_msg=f"step {step}")
        _rwkv_cache_close(cache, jcache)


def test_rwkv_fused_decode_in_place_matches_reference():
    """Three calls of ``RecurrentDecoder`` (the recurrent paths' fused
    decode: one graph replay on the card, the same steps eagerly here), two
    greedy steps each, on its static copy of the prefill cache: the streams
    are JAX's greedy streams, the cache matches JAX's after the six steps,
    and every cache tensor keeps its storage, as a captured graph needs."""
    jmodel, jparams, model = _pair("rwkv6-3b", True)
    tokens = np.random.default_rng(7).integers(0, 512, (3, 20)).astype(np.int32)
    want, jcache = jmodel.prefill(jparams, jax.numpy.asarray(tokens), 20)
    got, cache = model.prefill(torch.from_numpy(tokens))
    dec = RecurrentDecoder(model, decode_block=2)
    dec.start(cache, got[:, 0].argmax(-1).to(torch.int32))
    ptrs = {k: v.data_ptr() for k, v in dec.cache(3).items()}
    stream = torch.cat([dec().clone() for _ in range(3)]).T.numpy()
    tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
    j_stream = []
    for _ in range(6):
        want, jcache = jmodel.decode_step(jparams, jax.numpy.asarray(tok), jcache)
        tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
        j_stream.append(tok)
    np.testing.assert_array_equal(stream, np.concatenate(j_stream, 1))
    _rwkv_cache_close(dec.cache(3), jcache)
    assert {k: v.data_ptr() for k, v in dec.cache(3).items()} == ptrs


@pytest.mark.parametrize("decode_block", [0, -2])
def test_recurrent_decoder_refuses_empty_blocks(decode_block):
    """A decoder of fewer than one step a call is refused, not clamped."""
    _, _, model = _pair("rwkv6-3b", True)
    with pytest.raises(ValueError, match="decode_block"):
        RecurrentDecoder(model, decode_block=decode_block)


def test_rwkv_cache_layout_and_paged_refusal():
    _, _, model = _pair("rwkv6-3b", True)
    cfg = model.cfg
    cache = model.init_cache(3, 64)
    H, hd = cfg.d_model // cfg.rwkv_head_dim, cfg.rwkv_head_dim
    assert cache["wkv"].shape == (cfg.n_layers, 3, H, hd, hd)
    assert cache["shift_tm"].shape == cache["shift_cm"].shape == (cfg.n_layers, 3, cfg.d_model)
    with pytest.raises(ValueError, match="paged"):
        model.init_paged_cache(8, 16, 3)
    with pytest.raises(ValueError, match="paged"):
        model.decode_step(torch.zeros((3, 1), dtype=torch.int32), cache,
                          torch.zeros((3, 1), dtype=torch.int32))


def test_unported_families_raise():
    """The vision-language trunk (M-RoPE, the vision stub) and the
    encoder-decoder (the audio stub) build since they were ported
    (``tests/test_torch_encdec_vlm.py``), as do local-attention and RG-LRU
    blocks (the hybrid family), QK-norm and mixture-of-experts MLPs
    (``tests/test_torch_moe.py``) and LayerNorm dense stacks with
    squared-ReLU or GELU MLPs (``tests/test_torch_dense_layernorm.py``).
    What is not ported still raises: tied embeddings, an unknown family, a
    frontend on a recurrent stack, M-RoPE sections that do not cover the
    rotary half."""
    base = get_arch("tiny-s")
    half = base.head_dim // 2
    sections = (half // 4, half // 4 + half % 4, half // 2)
    for change in (dict(family="vlm", rope_type="mrope", mrope_sections=sections,
                        frontend="vision"),
                   dict(enc_dec=True, n_encoder_layers=2, family="audio", frontend="audio")):
        model = Model(dataclasses.replace(base, **change), device="cpu")
        assert (model.encoder is not None) == (change["family"] == "audio")
    for change in (dict(tie_embeddings=True), dict(family="diffusion"),
                   dict(family="vlm", rope_type="mrope", mrope_sections=(1, 1, 1),
                        frontend="vision"),
                   dict(family="dense", frontend="vision", enc_dec=True, n_encoder_layers=2)):
        with pytest.raises(NotImplementedError):
            Model(dataclasses.replace(base, **change), device="cpu")
    with pytest.raises(NotImplementedError, match="recurrent"):
        Model(dataclasses.replace(get_arch("rwkv6-3b").reduced(), frontend="audio"),
              device="cpu")
