"""Ingress: the network front door of the warm-pool extraction daemon
(the port's copy of ``video_features_tpu/ingress/``).

The loopback JSON-lines socket (``serve/protocol.py``) is a local
control surface; this package is what external traffic reaches. It is
HTTP/1.1 with chunked transfer both ways, on the standard library alone:
bounded concurrency, streamed request and response bodies for live
sessions, structured over-limit answers, and a drain that composes with
the daemon's SIGTERM path.

Modules:

  * ``http``    — transport: request framing and bounds, chunked
    streaming, the bounded accept loop, connection reaping;
  * ``auth``    — API-key tenancy: keys file → :class:`auth.Tenant`
    (name, priority class, quota parameters);
  * ``quota``   — per-tenant token-bucket rates and concurrent-request
    budgets;
  * ``live``    — live sessions: network frames → the extractor's window
    geometry → one streamed feature chunk per window;
  * ``gateway`` — the routes and the ``vft_ingress_*`` metrics, glued to
    :class:`serve.server.ExtractionServer`.

No module here imports torch; the daemon behind the gateway does.
"""
from video_features_torch.ingress.auth import ApiKeyAuth, Tenant  # noqa: F401
from video_features_torch.ingress.gateway import IngressGateway  # noqa: F401
from video_features_torch.ingress.quota import QuotaManager  # noqa: F401
