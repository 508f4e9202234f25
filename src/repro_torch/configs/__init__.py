"""Architecture configs of the port: the published shapes served so far
(``qwen1.5-0.5b``, ``qwen1.5-4b``, ``rwkv6-3b``, ``recurrentgemma-9b``, the
mixture-of-experts ``qwen2-moe-a2.7b`` and ``qwen3-moe-30b-a3b``, and the
LayerNorm dense ``stablelm-1.6b`` and ``nemotron-4-340b``) and the tiny
pool, each registered under its id."""
from repro_torch.configs import (  # noqa: F401
    nemotron_4_340b,
    qwen1_5_0_5b,
    qwen1_5_4b,
    qwen2_moe_a2_7b,
    qwen3_moe_30b_a3b,
    recurrentgemma_9b,
    rwkv6_3b,
    stablelm_1_6b,
    tiny_pool,
)
