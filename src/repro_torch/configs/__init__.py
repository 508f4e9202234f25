"""Architecture configs of the port: the published shapes served so far
(``qwen1.5-0.5b``, ``qwen1.5-4b``, ``rwkv6-3b``, ``recurrentgemma-9b``, the
mixture-of-experts ``qwen2-moe-a2.7b`` and ``qwen3-moe-30b-a3b``, the
LayerNorm dense ``stablelm-1.6b`` and ``nemotron-4-340b``, the
vision-language ``qwen2-vl-72b`` and the encoder-decoder
``seamless-m4t-large-v2``) and the tiny pool, each registered under its
id."""
from repro_torch.configs import (  # noqa: F401
    nemotron_4_340b,
    qwen1_5_0_5b,
    qwen1_5_4b,
    qwen2_moe_a2_7b,
    qwen2_vl_72b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    rwkv6_3b,
    seamless_m4t_large_v2,
    stablelm_1_6b,
    tiny_pool,
)
