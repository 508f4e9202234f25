"""Model configuration for the PyTorch port.

A copy of the JAX package's ``config.py`` (no import of it): ``ModelConfig``
and the architecture registry are unchanged, so a config built here and one
built there describe the same model field for field.  Architecture modules
under ``repro_torch.configs`` register the configs served so far
(``qwen1.5-0.5b``, ``rwkv6-3b``, ``recurrentgemma-9b`` and the tiny pool);
the other published configs are not ported yet and ``get_arch`` names them
as unknown.
"""
from __future__ import annotations

import dataclasses
import importlib
import math
from dataclasses import dataclass, replace
from typing import Optional, Sequence

# ---------------------------------------------------------------------------
# Model configuration
# ---------------------------------------------------------------------------

# Block kinds understood by the unified transformer stack.
BLOCK_ATTN = "attn"          # global causal (or bidirectional for encoders) attention
BLOCK_LOCAL_ATTN = "local"   # sliding-window attention
BLOCK_RGLRU = "rglru"        # RecurrentGemma RG-LRU recurrent block
BLOCK_RWKV = "rwkv"          # RWKV6 time-mix block
VALID_BLOCKS = {BLOCK_ATTN, BLOCK_LOCAL_ATTN, BLOCK_RGLRU, BLOCK_RWKV}


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (None on a ModelConfig => dense MLP)."""

    n_experts: int
    top_k: int
    d_expert: int                   # hidden width of each routed expert
    n_shared_experts: int = 0       # always-on shared experts (Qwen2-MoE style)
    d_shared: int = 0               # total hidden width of the fused shared expert
    router_aux_weight: float = 0.001  # load-balance auxiliary loss weight
    capacity_factor: float = 1.25   # used by the capacity-based dispatch path


@dataclass(frozen=True)
class ModelConfig:
    # identity
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    # trunk shape
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None  # defaults to d_model // n_heads
    # block pattern: repeated (cyclically) to cover n_layers.
    block_pattern: Sequence[str] = (BLOCK_ATTN,)
    window: Optional[int] = None    # sliding window size for BLOCK_LOCAL_ATTN
    # nonlinearity / norm
    activation: str = "swiglu"      # swiglu | geglu | gelu | relu2
    norm: str = "rmsnorm"           # rmsnorm | layernorm
    norm_eps: float = 1e-6
    # attention details
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    rotary_pct: float = 1.0
    rope_type: str = "rope"         # rope | mrope | none
    mrope_sections: Optional[Sequence[int]] = None  # (t, h, w) half-dim sections
    # encoder-decoder
    enc_dec: bool = False
    n_encoder_layers: int = 0
    # recurrent families
    rwkv_head_dim: int = 64
    lru_width: Optional[int] = None  # RG-LRU recurrence width (defaults to d_model)
    conv_width: int = 4              # temporal conv width in RG-LRU blocks
    # modality frontend: None | "vision" | "audio".  Frontends are STUBS: the
    # model consumes precomputed patch/frame embeddings via input_specs().
    frontend: Optional[str] = None
    # embeddings
    tie_embeddings: bool = False
    # numerics
    dtype: str = "bfloat16"
    # citation tag from the assignment table
    source: str = ""

    # -- derived ------------------------------------------------------------
    def __post_init__(self):
        if self.head_dim is None:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0, "GQA requires n_heads % n_kv_heads == 0"
        for b in self.block_pattern:
            assert b in VALID_BLOCKS, f"unknown block kind {b!r}"

    @property
    def attention_free(self) -> bool:
        return all(b in (BLOCK_RGLRU, BLOCK_RWKV) for b in self.block_pattern)

    @property
    def sub_quadratic(self) -> bool:
        """True if no block attends over unbounded context (SSM / local-attn hybrid)."""
        return all(b != BLOCK_ATTN for b in self.block_pattern)

    @property
    def uses_kv_cache(self) -> bool:
        return any(b in (BLOCK_ATTN, BLOCK_LOCAL_ATTN) for b in self.block_pattern)

    def layer_kinds(self) -> list[str]:
        pat = list(self.block_pattern)
        reps = math.ceil(self.n_layers / len(pat))
        return (pat * reps)[: self.n_layers]

    # -- parameter accounting (used by roofline + memory planning) ----------
    def param_count(self) -> int:
        """Exact trunk parameter count (matches the initialized pytree)."""
        d, hd = self.d_model, self.head_dim
        total = self.vocab_size * d                      # token embedding
        if not self.tie_embeddings:
            total += self.vocab_size * d                 # output head
        per_layer_by_kind = {}
        for kind in set(self.layer_kinds()):
            per_layer_by_kind[kind] = self._block_params(kind)
        total += sum(per_layer_by_kind[k] for k in self.layer_kinds())
        total += d  # final norm
        if self.enc_dec:
            # encoder trunk: self-attn blocks + decoder cross-attn adds
            enc_block = self._block_params(BLOCK_ATTN) + self._mlp_params()
            # _block_params for attn already includes one MLP; encoder layers are
            # identical to decoder self-attn layers, so reuse directly:
            total += self.n_encoder_layers * self._block_params(BLOCK_ATTN)
            total += self.n_encoder_layers * 0
            # decoder cross-attention (q from d_model, kv from encoder d_model) + norm
            total += self.n_layers * (d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd
                                      + self.n_heads * hd * d + d)
        return int(total)

    def _mlp_params(self) -> int:
        d = self.d_model
        if self.moe is not None:
            m = self.moe
            per_expert = (3 * d * m.d_expert
                          if self.activation in ("swiglu", "geglu")
                          else 2 * d * m.d_expert)
            shared = 3 * d * m.d_shared if m.d_shared else 0
            return m.n_experts * per_expert + shared + d * m.n_experts  # + router
        mult = 3 if self.activation in ("swiglu", "geglu") else 2
        return mult * d * self.d_ff

    def _block_params(self, kind: str) -> int:
        d, hd = self.d_model, self.head_dim
        norms = 2 * d
        if kind in (BLOCK_ATTN, BLOCK_LOCAL_ATTN):
            attn = d * self.n_heads * hd + 2 * d * self.n_kv_heads * hd + self.n_heads * hd * d
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv_heads) * hd
            return attn + self._mlp_params() + norms
        if kind == BLOCK_RGLRU:
            w = self.lru_width or d
            # linear in/out, gates (a and input gate), conv1d
            rec = 2 * d * w + 2 * w * w // 1 + self.conv_width * w + w
            return rec + self._mlp_params() + norms
        if kind == BLOCK_RWKV:
            # time-mix: r,k,v,g,o (5 d*d) + data-dependent decay LoRA (small) ;
            # channel-mix: k (d*ff) + v (ff*d) + r (d*d)
            tm = 5 * d * d + 6 * d * 32 * 2
            cm = 2 * d * self.d_ff + d * d
            return tm + cm + norms
        raise ValueError(kind)

    moe: Optional[MoEConfig] = None

    # -- reduced variants for CPU smoke tests -------------------------------
    def reduced(self) -> "ModelConfig":
        """A tiny config of the same family: same block pattern / features,
        small widths — used by per-arch smoke tests on CPU."""
        kw: dict = dict(
            name=self.name + "-smoke",
            n_layers=min(self.n_layers, 2 * len(self.block_pattern)),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            vocab_size=512,
            window=min(self.window, 32) if self.window else None,
            lru_width=64 if self.lru_width else None,
            rwkv_head_dim=16,
            n_encoder_layers=2 if self.enc_dec else 0,
            dtype="float32",
        )
        if self.moe is not None:
            # capacity_factor 8: the smoke tests check prefill/decode/forward
            # consistency, which capacity drops would legitimately break
            kw["moe"] = replace(self.moe, n_experts=min(self.moe.n_experts, 8),
                                top_k=min(self.moe.top_k, 2), d_expert=32,
                                d_shared=64 if self.moe.d_shared else 0,
                                capacity_factor=8.0)
        if self.mrope_sections is not None:
            kw["mrope_sections"] = (4, 2, 2)  # sums to head_dim // 2
        return replace(self, **kw)


# ---------------------------------------------------------------------------
# Kernel tiling knobs the dense serving path reads
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShardingConfig:
    """The fields of the JAX package's ``ShardingConfig`` that the port
    reads, with its defaults: the plain flash version's tile sizes and its
    causal block skip (serving), and the training loop's remat, gradient
    accumulation and accumulation dtype.  The mesh, ZeRO and FSDP knobs
    belong to a later slice."""

    remat: str = "block"                # none | block: recompute each block in backward
    microbatches: int = 1               # gradient accumulation steps
    acc_dtype: str = "float32"          # gradient-accumulation buffer dtype
    attn_q_block: int = 512             # flash-attention tile sizes
    attn_kv_block: int = 1024
    causal_skip: bool = True            # skip fully-masked KV blocks


# ---------------------------------------------------------------------------
# Architecture registry
# ---------------------------------------------------------------------------

_REGISTRY: dict[str, ModelConfig] = {}

# The published configs ported so far; the rest of the JAX package's zoo
# arrives with the model families that serve it.
ARCH_IDS = [
    "recurrentgemma-9b",
    "rwkv6-3b",
    "qwen1.5-0.5b",
]

_MODULE_FOR_ARCH = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
                    for a in ARCH_IDS}


def register_arch(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_arch(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        mod = _MODULE_FOR_ARCH.get(name)
        if mod is None:
            # allow ad-hoc registered names (e.g. tiny pool members)
            importlib.import_module("repro_torch.configs")
        else:
            importlib.import_module(mod)
    if name not in _REGISTRY:
        raise KeyError(f"unknown architecture {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_archs() -> list[str]:
    return list(ARCH_IDS)


# dataclass field ordering fix-up: `moe` was declared after methods above so it
# participates in replace()/asdict; verify it exists.
assert any(f.name == "moe" for f in dataclasses.fields(ModelConfig))
