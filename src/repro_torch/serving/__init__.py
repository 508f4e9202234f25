"""Serving plane of the port: the paged continuous-batching engine, the
CUDA graphs its fused decode replays (``graphs``), and the host-side helpers
it uses (page allocator, batch-prompt formatter, generation config); the
served pool members over the engines (``pool``), fault tolerance, replica
autoscaling, the semantic cache and the online server RoBatch streams
queries through (``fault``, ``autoscale``, ``semcache``, ``online``)."""
