"""The warm-pool extraction service (the port's copy of
``video_features_tpu/serve/``).

``python -m video_features_torch serve`` starts the daemon
(:mod:`serve.server`); :mod:`serve.client` talks to it, and to the JAX
package's daemon, over the same wire (:mod:`serve.protocol`);
:mod:`serve.pool` keeps extractors resident; :mod:`serve.metrics` is the
live health surface. Only ``server`` imports torch.
"""
from video_features_torch.serve.client import ServeClient, ServeError  # noqa: F401
from video_features_torch.serve.pool import WarmPool  # noqa: F401

__all__ = ['ServeClient', 'ServeError', 'WarmPool', 'ExtractionServer']


def __getattr__(name):
    # the server pulls in config, the registry and torch; clients need none
    if name == 'ExtractionServer':
        from video_features_torch.serve.server import ExtractionServer
        return ExtractionServer
    raise AttributeError(name)
