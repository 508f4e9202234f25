"""Serving plane of the port: the paged continuous-batching engine, the
CUDA graphs its fused decode replays (``graphs``), and the host-side helpers
it uses (page allocator, batch-prompt formatter, generation config)."""
