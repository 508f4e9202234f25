"""Qwen3-30B-A3B — 128-expert top-8 MoE [hf:Qwen/Qwen3-30B-A3B; hf]."""
from repro_torch.config import ModelConfig, MoEConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="qwen3-moe-30b-a3b",
    family="moe",
    n_layers=48,
    d_model=2048,
    n_heads=32,
    n_kv_heads=4,
    head_dim=128,
    d_ff=768,                       # routed expert width (moe_intermediate_size)
    vocab_size=151_936,
    moe=MoEConfig(n_experts=128, top_k=8, d_expert=768),
    activation="swiglu",
    norm="rmsnorm",
    qk_norm=True,                   # Qwen3 q/k RMSNorm
    rope_theta=1_000_000.0,
    source="hf:Qwen/Qwen3-30B-A3B",
))
