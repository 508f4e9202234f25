"""Nemotron-4-340B — GQA, squared-ReLU MLP [arXiv:2402.16819; unverified]."""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18_432,
    n_heads=96,
    n_kv_heads=8,
    head_dim=192,
    d_ff=73_728,
    vocab_size=256_000,
    activation="relu2",             # squared ReLU, ungated
    norm="layernorm",
    rotary_pct=0.5,
    rope_theta=10_000.0,
    source="arXiv:2402.16819",
))
