"""Serving plane of the port: the paged continuous-batching engine and the
host-side helpers it uses (page allocator, batch-prompt formatter,
generation config)."""
