"""Content-addressed feature cache (the port's copy of
``video_features_tpu/cache/``): a repeated (video content, family,
config, checkpoint) is answered by copying the stored outputs, with no
decode and no step on the card.

Key derivation is in :mod:`.key`, the store (manifest, objects, LRU
eviction, integrity checks) in :mod:`.store`, the offline maintenance in
:mod:`.gc` (``python -m video_features_torch.cache.gc``). No module here
imports torch.
"""
from video_features_torch.cache.key import (  # noqa: F401
    CONFIG_KEY_EXCLUDE, config_fingerprint, hash_file, run_fingerprint,
    video_cache_key, weights_fingerprint,
)
from video_features_torch.cache.store import (  # noqa: F401
    FeatureCache, log_cache_error, merge_cache_stats,
)
