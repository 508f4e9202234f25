"""StableLM-2-1.6B — partial rotary (25%), LayerNorm
[hf:stabilityai/stablelm-2-1_6b; unverified]."""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="stablelm-1.6b",
    family="dense",
    n_layers=24,
    d_model=2048,
    n_heads=32,
    n_kv_heads=32,
    d_ff=5632,
    vocab_size=100_352,
    activation="swiglu",
    norm="layernorm",
    rotary_pct=0.25,
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b",
))
