"""Qwen1.5-4B — dense, QKV bias [hf:Qwen/Qwen1.5-4B; hf]."""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab_size=151_936,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=5_000_000.0,
    source="hf:Qwen/Qwen1.5-4B",
))
