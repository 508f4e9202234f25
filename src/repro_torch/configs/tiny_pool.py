"""Tiny real model pool: three dense LMs of ascending capacity.

Copied from the JAX package; there they are trained and served by
examples/serve_pool.py as the counterpart of the paper's Qwen3 API pool.
"""
from repro_torch.config import ModelConfig, register_arch

TINY_POOL = [
    register_arch(ModelConfig(
        name=f"tiny-{tag}", family="dense", n_layers=nl, d_model=dm, n_heads=nh,
        n_kv_heads=nh, d_ff=4 * dm, vocab_size=512, rope_theta=10_000.0,
        dtype="float32", source="repro:tiny-pool"))
    for tag, nl, dm, nh in [("s", 2, 64, 2), ("m", 4, 128, 4), ("l", 4, 192, 6)]
]
