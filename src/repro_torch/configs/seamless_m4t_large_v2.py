"""SeamlessM4T-large-v2 backbone — enc-dec, multimodal [arXiv:2308.11596; hf].

The audio frontend is a STUB: ``repro_torch.launch.specs`` makes
precomputed frame embeddings from a seed for the 24-layer encoder; the
24-layer decoder (self + cross attention) is fully implemented.  "24L" is
read as the per-stack depth of the encoder-decoder.
"""
from repro_torch.config import ModelConfig, register_arch

CONFIG = register_arch(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,                    # decoder layers
    n_encoder_layers=24,
    enc_dec=True,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=8192,
    vocab_size=256_206,
    activation="gelu",
    norm="layernorm",
    rope_theta=10_000.0,
    frontend="audio",
    source="arXiv:2308.11596",
))
