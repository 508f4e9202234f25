"""HTTP front-end for the RoBatch serving plane: an OpenAI-compatible wire
surface (``/v1/chat/completions`` with SSE streaming, ``/v1/models``), health
(``/healthz``) and Prometheus metrics (``/metrics``) — stdlib-only.

Entry points::

    from repro_torch.http import HttpFrontend, MetricsRegistry

    fe = HttpFrontend(online_server, port=0).start()   # or Gateway.serve_http
    ...
    fe.stop()

or from the CLI: ``python -m repro_torch.launch.serve http --port 8080``.

The package is the JAX package's ``http/`` (which imports no JAX), copied
with its imports turned to the port's modules, so its wire format and
metrics text are the same.
"""
from repro_torch.http.metrics import (Counter, Gauge, Histogram, MetricsRegistry,
                                      bind_server_metrics)
from repro_torch.http.server import HttpFrontend

__all__ = ["HttpFrontend", "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "bind_server_metrics"]
