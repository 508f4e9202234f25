"""Qwen1.5-MoE-A2.7B — 4 shared + 60 routed top-4 [hf:Qwen/Qwen1.5-MoE-A2.7B; hf]."""
from repro_torch.config import ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    n_layers=24,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    d_ff=1408,                      # routed expert width
    vocab_size=151_936,
    moe=MoEConfig(n_experts=60, top_k=4, d_expert=1408,
                  n_shared_experts=4, d_shared=5632),   # shared width = 4×1408
    activation="swiglu",
    norm="rmsnorm",
    qkv_bias=True,
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
))
