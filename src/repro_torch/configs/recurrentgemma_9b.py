"""RecurrentGemma-9B — RG-LRU + local attention, 1:2 [arXiv:2402.19427; unverified]."""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,                    # 12 × (rec, rec, local-attn) + 2 rec tail
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,                   # MQA
    head_dim=256,
    d_ff=12_288,
    vocab_size=256_000,
    block_pattern=("rglru", "rglru", "local"),
    window=2048,
    lru_width=4096,
    conv_width=4,
    activation="geglu",
    norm="rmsnorm",
    rope_theta=10_000.0,
    source="arXiv:2402.19427",
))
