"""Qwen1.5-0.5B — dense, QKV bias [hf:Qwen/Qwen1.5-0.5B; hf]."""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen1.5-0.5b",
    family="dense",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab_size=151_936,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-0.5B",
))
