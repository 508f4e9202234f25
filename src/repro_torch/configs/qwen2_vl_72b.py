"""Qwen2-VL-72B backbone — M-RoPE, dynamic resolution [arXiv:2409.12191; hf].

The vision frontend is a STUB: ``repro_torch.launch.specs`` makes
precomputed patch embeddings from a seed; the trunk (with 3-section M-RoPE)
is fully implemented.
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=29_568,
    vocab_size=152_064,
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_type="mrope",
    mrope_sections=(16, 24, 24),    # t/h/w sections of head_dim/2
    rope_theta=1_000_000.0,
    frontend="vision",
    source="arXiv:2409.12191",
))
