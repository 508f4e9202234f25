"""RWKV6 "Finch" 3B — attention-free, data-dependent decay [arXiv:2404.05892; hf]."""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="rwkv6-3b",
    family="ssm",
    n_layers=32,
    d_model=2560,
    n_heads=40,                     # d_model / rwkv_head_dim
    n_kv_heads=40,
    d_ff=8960,                      # 3.5 × d_model channel-mix width
    vocab_size=65_536,
    block_pattern=("rwkv",),
    rwkv_head_dim=64,
    rope_type="none",
    norm="layernorm",
    source="arXiv:2404.05892",
))
