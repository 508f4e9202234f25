"""The port's encoder-decoder and vision-language families against the JAX
package's, on the CPU: SeamlessM4T-large-v2 (a non-causal encoder over
frame embeddings, decoder blocks with cross-attention, LayerNorm, GELU) and
Qwen2-VL-72B (M-RoPE over temporal, height and width ids, QKV bias,
embedding inputs), in fp32, with JAX's weights carried by the weight
bridge.

The config copies equal JAX's field for field; the model's own parameter
count (on the ``meta`` device) is JAX's tree's, and the reference's
``param_count`` undercount of SeamlessM4T is pinned.  The plain flash
version without the causal mask and with more keys than queries (the
encoder and the cross-attention) against ``_flash_jnp`` and ``mha_ref``
(and at Sq = Skv the Pallas kernel in interpret mode), the decode version
over an encoder's K/V against ``_decode_jnp`` and the Pallas kernel, in fp32
(2e-5) and bf16 (2e-2); M-RoPE's tables against JAX's ``apply_rope`` at an
image grid's positions.  Then reduced models: forward, prefill (logits and
the self and cross caches) and greedy decode within 1e-4 of JAX and token
for token; Qwen2-VL's text prompts served by both engine layouts as the JAX
engine serves them; SeamlessM4T's greedy decode through ``RecurrentDecoder``
with capture emulated equal to eager; and the stub inputs' shapes against
``launch/specs.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import ShapeConfig
from repro.config import ShardingConfig as JaxShardingConfig
from repro.config import get_arch as jax_get_arch
from repro.kernels import ops as jops
from repro.kernels.decode_attention import decode_attention_pallas
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.ref import mha_ref
from repro.launch import specs as jspecs
from repro.models.layers import apply_rope as jax_apply_rope
from repro.models.transformer import Model as JaxModel
from repro.serving import engine as jengine
from repro_torch.config import ARCH_IDS, get_arch
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.kernels.decode_attention import decode_attention_plain
from repro_torch.kernels.flash_attention import flash_attention_plain
from repro_torch.launch import specs
from repro_torch.models.bridge import flatten_tree, state_from_jax
from repro_torch.models.layers import apply_rope, rope_freqs, rope_tables
from repro_torch.models.transformer import Model
from repro_torch.serving import engine
from repro_torch.serving.graphs import RecurrentDecoder
from test_torch_engine import EmulatedGraphs

LOGIT_TOL = 1e-4
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
ARCHS = ["seamless-m4t-large-v2", "qwen2-vl-72b"]
# the reference's ModelConfig.param_count and JAX's tree (``Model.param_count``
# over its leaves)
PARAMS = {"seamless-m4t-large-v2": (1_632_130_048, 1_632_292_864),
          "qwen2-vl-72b": (72_706_203_648, 72_706_203_648)}
TOK = ByteTokenizer()
ENC_LEN = 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's side on one thread: under the parallel test workers a
    thread pool a process costs these small models several times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _small(arch):
    """``reduced()`` in both packages; SeamlessM4T's vocabulary set to 500,
    not a multiple of 32, so the 12 padded logits are masked."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    if arch.startswith("seamless"):
        jcfg, cfg = (dataclasses.replace(c, vocab_size=500) for c in (jcfg, cfg))
    return jcfg, cfg


# ---- configs and the parameter count --------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_copy_and_param_count(arch):
    """The copy equals the reference field for field and is listed as JAX
    lists it.  The model's own count, on ``meta``, is JAX's tree's; for
    SeamlessM4T the reference's ``param_count`` leaves out the bias of each
    of its 122 LayerNorms (2 an encoder layer, 3 a decoder layer, the two
    final norms), the encoder's final norm's scale, and the 18 padded
    vocabulary rows of the embedding and of the head."""
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert arch in ARCH_IDS
    said, held = PARAMS[arch]
    assert cfg.param_count() == jcfg.param_count() == said
    assert JaxModel(jcfg).param_count() == held
    assert Model(cfg, device="meta").param_count() == held
    if cfg.enc_dec:
        d, padded = cfg.d_model, -(-cfg.vocab_size // 32) * 32
        n_norms = 2 * cfg.n_encoder_layers + 3 * cfg.n_layers + 2
        assert n_norms == 122
        assert held - said == n_norms * d + d + 2 * (padded - cfg.vocab_size) * d == 162_816
    for c, jc in ((cfg.reduced(), jcfg.reduced()),):
        assert dataclasses.asdict(c) == dataclasses.asdict(jc)
    assert get_arch("qwen2-vl-72b").reduced().mrope_sections == (4, 2, 2)
    assert get_arch("seamless-m4t-large-v2").reduced().n_encoder_layers == 2


def test_qwen2_vl_first_eight_layers_are_19_gb():
    """The size the card serves: Qwen2-VL-72B's first 8 of 80 layers at
    full width, 9,512,902,656 parameters, 19.0 GB in bf16."""
    cfg = dataclasses.replace(get_arch("qwen2-vl-72b"), n_layers=8)
    jcfg = dataclasses.replace(jax_get_arch("qwen2-vl-72b"), n_layers=8)
    n = Model(cfg, device="meta").param_count()
    assert n == JaxModel(jcfg).param_count() == 9_512_902_656


# ---- the kernels' plain versions -------------------------------------------

def _arrs(rng, dtype, *shapes):
    """The same draws as a torch tensor and a jax array, rounded to dtype."""
    tdt, jdt = DTYPES[dtype]
    out = []
    for shape in shapes:
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(tdt)
        out.append((t, jnp.asarray(t.float().numpy(), jdt)))
    return out


def _kernel_close(got, want, dtype):
    _close(got.float().numpy(), want, KERNEL_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sq,skv,causal", [(37, 37, False), (5, 37, False), (5, 37, True),
                                           (1, 45, True), (64, 45, False)])
def test_flash_plain_encoder_and_cross_match_jax(sq, skv, causal, dtype):
    """16-wide tiles over ragged lengths, GQA 8 on 2: not causal (the
    encoder at Sq = Skv, the cross-attention at Sq ≠ Skv) and causal with
    the sequence ends aligned, against ``_flash_jnp`` and ``mha_ref``; at Sq
    = Skv also the Pallas kernel in interpret mode, which asserts Sq = Skv."""
    rng = np.random.default_rng(sq * 100 + skv)
    (q, jq), (k, jk), (v, jv) = _arrs(rng, dtype, (2, sq, 8, 32), (2, skv, 2, 32),
                                      (2, skv, 2, 32))
    got = flash_attention_plain(q, k, v, causal=causal, q_block=16, kv_block=16)
    assert got.dtype == q.dtype and got.shape == q.shape
    _kernel_close(got, jops._flash_jnp(jq, jk, jv, causal=causal, window=None, q_block=16,
                                       kv_block=16, causal_skip=True), dtype)
    _kernel_close(got, mha_ref(jq, jk, jv, causal=causal), dtype)
    if sq == skv:
        _kernel_close(got, flash_attention_pallas(jq, jk, jv, causal=causal, q_block=16,
                                                  kv_block=16, interpret=True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_decode_plain_matches_jax(dtype):
    """One decoder token over an encoder's K/V (16 heads of 64 as
    SeamlessM4T's): every frame valid, and the edges 1 and enc_len − 1."""
    rng = np.random.default_rng(64)
    B, S, H, D = 4, 70, 16, 64
    (q, jq), (k, jk), (v, jv) = _arrs(rng, dtype, (B, 1, H, D), (B, S, H, D), (B, S, H, D))
    lengths = np.asarray([S, 1, S - 1, S], np.int32)
    got = decode_attention_plain(q, k, v, torch.from_numpy(lengths))
    jl = jnp.asarray(lengths)
    _kernel_close(got, jops._decode_jnp(jq, jk, jv, jl), dtype)
    _kernel_close(got, decode_attention_pallas(jq, jk, jv, jl, kv_block=32, interpret=True),
                  dtype)


# ---- M-RoPE ----------------------------------------------------------------

def test_mrope_positions_follow_qwen2_vl():
    """Text t = h = w = i; an image's patch (r, c) at (s, s + r, s + c); the
    text after it resumes at s + max(grid_h, grid_w)."""
    pos = specs.mrope_positions(3, 2, 4, 2).numpy()
    assert pos.shape == (3, 3 + 8 + 2) and pos.dtype == np.int32
    np.testing.assert_array_equal(pos[:, :3], [[0, 1, 2]] * 3)
    np.testing.assert_array_equal(pos[0, 3:11], [3] * 8)
    np.testing.assert_array_equal(pos[1, 3:11], [3, 3, 3, 3, 4, 4, 4, 4])
    np.testing.assert_array_equal(pos[2, 3:11], [3, 4, 5, 6] * 2)
    np.testing.assert_array_equal(pos[:, 11:], [[7, 8]] * 3)


def test_mrope_tables_match_jax_apply_rope():
    """At an image grid's positions (sections (4, 2, 2) of rot/2 = 8, and
    Qwen2-VL's (16, 24, 24) at head_dim 128) the rotated heads are JAX's
    ``apply_rope``'s within 1e-6; text positions (the same id three times)
    give plain RoPE's tables bit for bit."""
    for arch_cfg in (get_arch("qwen2-vl-72b").reduced(), get_arch("qwen2-vl-72b")):
        hd = arch_cfg.head_dim
        inv = torch.as_tensor(rope_freqs(hd, 1.0, arch_cfg.rope_theta), dtype=torch.float32)
        pos3 = torch.stack([specs.mrope_positions(3, 4, 5, 6), specs.mrope_positions(2, 6, 3, 9)
                            + 7])
        x = np.random.default_rng(5).normal(size=(2, pos3.shape[-1], 3, hd)).astype(np.float32)
        got = apply_rope(torch.from_numpy(x), rope_tables(pos3, inv, arch_cfg.mrope_sections))
        want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos3.numpy()), arch_cfg)
        _close(got.numpy(), want, 1e-6)
        text = torch.arange(40, dtype=torch.int32)[None].expand(2, 40)
        t3 = rope_tables(text[:, None].expand(2, 3, 40), inv, arch_cfg.mrope_sections)
        for a, b in zip(t3, rope_tables(text, inv)):
            assert torch.equal(a, b)
    with pytest.raises(ValueError, match="sum"):
        rope_tables(pos3, inv, (16, 24, 23))


# ---- the models ------------------------------------------------------------

_PAIRS: dict = {}


def _pair(arch):
    """(JAX model, its params, the port's model with the same weights)."""
    if arch not in _PAIRS:
        jcfg, cfg = _small(arch)
        jmodel = JaxModel(jcfg, JaxShardingConfig(remat="none"))
        jparams = jmodel.init(jax.random.PRNGKey(11))
        model = Model(cfg, device="cpu")
        model.load_state_dict(state_from_jax(jax.tree.map(np.asarray, jparams), cfg))
        _PAIRS[arch] = (jmodel, jparams, model)
    return _PAIRS[arch]


def _frames(cfg, B, seed=3):
    return specs.frame_embeddings(cfg, B, seed, n_frames=ENC_LEN, device="cpu")


def test_bridge_maps_encoder_and_cross_leaves():
    """Every leaf of SeamlessM4T's JAX tree lands unchanged (strict load):
    the encoder's stacked blocks and final norm, the decoder's ``nc`` and
    ``cross`` (no bias); an encoder leaf for a config without an encoder,
    or of the wrong depth, is refused."""
    _, jparams, model = _pair("seamless-m4t-large-v2")
    flat = flatten_tree(jax.tree.map(np.asarray, jparams))
    cfg = model.cfg
    assert {"encoder/norm/scale", "encoder/norm/bias", "blocks/b0/nc/bias",
            "blocks/b0/cross/q/w", "encoder/blocks/b0/attn/q/w"} <= set(flat)
    assert not any(k.startswith("blocks/b0/cross/") and k.endswith("/b") for k in flat)
    state = model.state_dict()
    for g in range(cfg.n_encoder_layers):
        np.testing.assert_array_equal(state[f"encoder.blocks.{g}.mlp.up.w"].numpy(),
                                      flat["encoder/blocks/b0/mlp/up/w"][g])
    for i in range(cfg.n_layers):
        np.testing.assert_array_equal(state[f"blocks.{i}.cross.k.w"].numpy(),
                                      flat["blocks/b0/cross/k/w"][i])
    np.testing.assert_array_equal(state["encoder.norm.bias"].numpy(), flat["encoder/norm/bias"])
    with pytest.raises(ValueError, match="encoder layers"):
        state_from_jax({"encoder/blocks/b0/n1/scale": flat["encoder/blocks/b0/n1/scale"][:1]},
                       cfg)
    with pytest.raises(ValueError, match="no encoder"):
        state_from_jax({"encoder/norm/scale": flat["encoder/norm/scale"]},
                       get_arch("qwen2-vl-72b").reduced())


def test_encdec_forward_matches_reference():
    """Teacher-forced logits of the decoder over the encoder's output."""
    jmodel, jparams, model = _pair("seamless-m4t-large-v2")
    rng = np.random.default_rng(4)
    tokens = rng.integers(0, 500, (2, 11)).astype(np.int32)
    enc = _frames(model.cfg, 2)
    want, _ = jmodel.forward(jparams, jnp.asarray(tokens), enc_inputs=jnp.asarray(enc.numpy()))
    got, aux = model.forward(torch.from_numpy(tokens), enc_inputs=enc)
    _close(got.numpy(), want, LOGIT_TOL)
    assert float(aux) == 0.0
    assert bool((got[..., 500:] == -1e30).all())
    with pytest.raises(ValueError, match="enc_inputs"):
        model.forward(torch.from_numpy(tokens))


def test_encdec_prefill_caches_and_greedy_decode_match_reference():
    """A right-padded prefill with ``lengths`` into caches of ``max_len``:
    logits, the self K/V and the cross K/V within 1e-4; then 8 greedy
    ``decode_step``s token for token and logits within 1e-4 of JAX's loop.
    JAX's ``prefill`` writes ``lengths`` into every int32 leaf of its cache,
    the cross ``len`` among them, so its decode would read only the first
    ``lengths[b]`` frames; the port keeps every frame (its ``cross_len`` is
    the frame count), so JAX's loop runs here with that leaf set back to
    the frame count, as its cache without ``lengths`` holds it."""
    jmodel, jparams, model = _pair("seamless-m4t-large-v2")
    cfg = model.cfg
    rng = np.random.default_rng(5)
    B, S, max_len = 3, 12, 24
    tokens = rng.integers(0, 500, (B, S)).astype(np.int32)
    lengths = np.asarray([S, 5, 9], np.int32)
    enc = _frames(cfg, B, seed=6)
    lengths_t = torch.from_numpy(lengths.copy())
    want, jcache = jmodel.prefill(jparams, jnp.asarray(tokens), max_len,
                                  enc_inputs=jnp.asarray(enc.numpy()),
                                  lengths=jnp.asarray(lengths))
    got, cache = model.prefill(torch.from_numpy(tokens), lengths=lengths_t, max_len=max_len,
                               enc_inputs=enc)
    _close(got.numpy(), want, LOGIT_TOL)
    jb = jcache["blocks"]["b0"]
    for name in ("k", "v"):
        _close(cache[name].numpy(), jb[name], LOGIT_TOL)
        _close(cache[f"cross_{name}"].numpy(), jb["cross"][name], LOGIT_TOL)
    assert cache["cross_k"].shape == (cfg.n_layers, B, ENC_LEN, cfg.n_kv_heads, cfg.head_dim)
    np.testing.assert_array_equal(cache["len"].numpy(), lengths)
    np.testing.assert_array_equal(cache["cross_len"].numpy(), [ENC_LEN] * B)
    # the reference's cross lengths are the prompt lengths (pinned)
    np.testing.assert_array_equal(np.asarray(jb["cross"]["len"]), np.tile(lengths, (2, 1)))
    jb["cross"]["len"] = jnp.full_like(jb["cross"]["len"], ENC_LEN)
    tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
    assert np.array_equal(tok[:, 0], got[:, 0].argmax(-1).numpy())
    step = jax.jit(jmodel.decode_step)
    for _ in range(8):
        want, jcache = step(jparams, jnp.asarray(tok), jcache)
        got = model.decode_step(torch.from_numpy(tok), cache)
        _close(got.numpy(), want, LOGIT_TOL)
        tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(got[:, 0].argmax(-1).numpy(), tok[:, 0])
    np.testing.assert_array_equal(cache["len"].numpy(), lengths + 8)
    np.testing.assert_array_equal(lengths_t.numpy(), lengths)     # the caller's, not the cache


def test_encdec_refusals_and_init_cache():
    """JAX pages decoder-only stacks and spans global-attention decoders
    only; the engine serves decoder-only stacks; ``init_cache`` lays the
    cross K/V out beside the self K/V."""
    _, _, model = _pair("seamless-m4t-large-v2")
    cfg = model.cfg
    cache = model.init_cache(3, 20, enc_len=ENC_LEN)
    assert cache["cross_v"].shape == (cfg.n_layers, 3, ENC_LEN, cfg.n_kv_heads, cfg.head_dim)
    assert cache["cross_len"].tolist() == [ENC_LEN] * 3
    with pytest.raises(ValueError, match="paged"):
        model.init_paged_cache(8, 16, 3)
    with pytest.raises(ValueError, match="paged"):
        model.decode_step(torch.zeros((3, 1), dtype=torch.int32), cache,
                          torch.zeros((3, 1), dtype=torch.int32))
    with pytest.raises(ValueError, match="cross-attention"):
        model.decode_span(torch.zeros((3, 2), dtype=torch.int32), cache)
    with pytest.raises(ValueError, match="decoder-only"):
        engine.ServingEngine(model, device="cpu")


def test_encdec_recurrent_decoder_graphed_matches_eager():
    """``RecurrentDecoder`` over the flat cache (the cross K/V among its
    leaves), 3 calls of 8 greedy steps: with capture emulated the streams
    and every cache leaf equal the eager decoder's, and the cross K/V are
    left as the prefill wrote them."""
    _, _, model = _pair("seamless-m4t-large-v2")
    tokens = torch.from_numpy(np.random.default_rng(7).integers(0, 500, (2, 9)).astype(np.int32))
    logits, cache = model.prefill(tokens, max_len=40, enc_inputs=_frames(model.cfg, 2, 8))
    first = logits[:, 0].argmax(-1).to(torch.int32)
    out = {}
    for leg in ("graphed", "eager"):
        dec = RecurrentDecoder(model, decode_block=8)
        if leg == "graphed":
            gs = dec.graphs = EmulatedGraphs()
        dec.start(cache, first)
        out[leg] = (torch.cat([dec().clone() for _ in range(3)]), dec.cache(2))
    assert torch.equal(out["graphed"][0], out["eager"][0])
    for k, v in out["graphed"][1].items():
        assert torch.equal(v, out["eager"][1][k]), k
    assert torch.equal(out["eager"][1]["cross_k"], cache["cross_k"])
    assert len(gs.graphs) == 1 and gs.n_replays == 2


def test_vlm_forward_with_image_grid_positions_matches_reference():
    """Patch-and-text embeddings (4 text tokens, a 3 × 4 grid, 5 text
    tokens) with M-RoPE's three ids a token: logits within 1e-4."""
    jmodel, jparams, model = _pair("qwen2-vl-72b")
    cfg = model.cfg
    pos = specs.mrope_positions(4, 3, 4, 5)
    S = pos.shape[-1]
    embeds = specs.patch_embeddings(cfg, 2, S, seed=9, device="cpu")
    pos3 = torch.stack([pos, pos + 2])
    want, _ = jmodel.forward(jparams, jnp.asarray(embeds.numpy()),
                             positions=jnp.asarray(pos3.numpy()))
    got, _ = model.forward(embeds, positions=pos3)
    _close(got.numpy(), want, LOGIT_TOL)
    # the image's ids matter: text positions give other logits
    plain, _ = model.forward(embeds)
    assert (plain - got).abs().max() > 1e-3


def test_vlm_prefill_from_embeddings_then_decode_matches_reference():
    """A prefill of embeddings (text positions, as JAX's ``prefill``), then
    4 greedy steps of token ids and one of an embedding: logits within 1e-4
    and the same tokens."""
    jmodel, jparams, model = _pair("qwen2-vl-72b")
    cfg = model.cfg
    embeds = specs.patch_embeddings(cfg, 2, 13, seed=10, device="cpu")
    want, jcache = jmodel.prefill(jparams, jnp.asarray(embeds.numpy()), 24)
    got, cache = model.prefill(embeds, max_len=24)
    _close(got.numpy(), want, LOGIT_TOL)
    step = jax.jit(jmodel.decode_step)
    tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
    for _ in range(4):
        want, jcache = step(jparams, jnp.asarray(tok), jcache)
        got = model.decode_step(torch.from_numpy(tok), cache)
        _close(got.numpy(), want, LOGIT_TOL)
        tok = np.asarray(want)[:, 0].argmax(-1).astype(np.int32)[:, None]
        np.testing.assert_array_equal(got[:, 0].argmax(-1).numpy(), tok[:, 0])
    e = specs.decode_inputs(cfg, 2, seed=11, device="cpu")["tokens"]
    want, _ = step(jparams, jnp.asarray(e.numpy()), jcache)
    _close(model.decode_step(e, cache).numpy(), want, LOGIT_TOL)


def _workload():
    """Six text requests, two admission rounds on 4 slots."""
    sys_ = "system: describe. "
    prompts = [sys_ + "same", sys_ + "same", sys_ + "q1 " + "ab" * 9, "x" * 40,
               sys_ + "q2", sys_ + "q3 " + "cd" * 4]
    return [(TOK.encode(p), m) for p, m in zip(prompts, (6, 9, 12, 5, 14, 8))]


@pytest.mark.parametrize("paged", [True, False])
def test_vlm_text_serving_matches_reference_engine(paged):
    """Qwen2-VL's trunk serves text prompts as a decoder-only stack (M-RoPE
    on text positions): both engines (4 slots, K = 4, page 8) give the same
    streams, counters and occupancy."""
    jmodel, jparams, model = _pair("qwen2-vl-72b")
    kw = dict(max_slots=4, max_len=96, decode_block=4, paged=paged, page_size=8, eos_id=-1)
    ref = jengine.ServingEngine(jmodel, jparams, **kw)
    eng = engine.ServingEngine(model, device="cpu", **kw)
    r_ref = [jengine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    r_got = [engine.Request(rid=i, tokens=t, max_new=m) for i, (t, m) in enumerate(_workload())]
    ref.serve(r_ref)
    eng.serve(r_got)
    assert [r.out_tokens for r in r_got] == [r.out_tokens for r in r_ref]
    assert (eng.n_decode_calls, eng.n_decode_steps, eng.n_prefill_calls) == \
        (ref.n_decode_calls, ref.n_decode_steps, ref.n_prefill_calls)
    assert eng.kv_occupancy() == ref.kv_occupancy()


# ---- the stub inputs and the launcher ---------------------------------------

@pytest.mark.parametrize("arch", ARCHS + ["qwen1.5-0.5b"])
def test_stub_input_shapes_match_reference_specs(arch):
    """``batch_inputs``, ``prefill_inputs`` and ``decode_inputs`` make
    tensors of the JAX specs' keys and shapes (the model dtype for the
    embeddings, int32 ids)."""
    jcfg, cfg = jax_get_arch(arch).reduced(), get_arch(arch).reduced()
    assert specs.AUDIO_ENC_FRAMES == jspecs.AUDIO_ENC_FRAMES
    assert specs.enc_len_for(cfg) == jspecs.enc_len_for(jcfg, None)
    for kind, ours in (("train", specs.batch_inputs(cfg, 2, 40, 0, device="cpu")),
                       ("prefill", specs.prefill_inputs(cfg, 2, 40, 0, device="cpu")),
                       ("decode", specs.decode_inputs(cfg, 2, 0, device="cpu"))):
        shape = ShapeConfig("t", kind, 40, 2)
        fn = {"train": jspecs.batch_inputs, "prefill": jspecs.prefill_inputs,
              "decode": jspecs.decode_inputs}[kind]
        want = fn(jcfg, shape)
        assert set(ours) == set(want), kind
        for k, t in ours.items():
            assert tuple(t.shape) == want[k].shape, (kind, k)
            assert (t.dtype == torch.int32) == (want[k].dtype == jnp.int32), (kind, k)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_refuses_frontend_configs(arch):
    """Byte-tokenizer text serving refuses a frontend or an encoder, as the
    JAX launcher does."""
    from repro_torch.launch import serve as launcher

    with pytest.raises(SystemExit, match="byte-tokenizer"):
        launcher.engine_main(["--arch", arch, "--device", "cpu", "--requests", "1"])
