"""The weights part of the resume fingerprint: the content of each
checkpoint file (and of vggish's PCA file), not its path (a jax-free
copy of ``hash_file`` and ``weights_fingerprint`` of
``video_features_tpu/cache/key.py``).

A file rewritten in place changes the fingerprint, so stale outputs are
re-extracted; the same bytes under a new path keep it, so they are not.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Iterable, Mapping

_CHUNK = 1 << 20        # streaming-read granularity
# what CLIP's model_name=custom loads when no checkpoint_path is given
CLIP_CUSTOM_CHECKPOINT = './checkpoints/CLIP-custom.pth'


def hash_file(path: str) -> str:
    """Streaming SHA-256 of a file's content."""
    h = hashlib.sha256()
    with open(os.path.realpath(path), 'rb') as f:
        for chunk in iter(lambda: f.read(_CHUNK), b''):
            h.update(chunk)
    return h.hexdigest()


def is_file_key(key: str) -> bool:
    """True for the config keys whose file enters the fingerprint by its
    content: every ``*checkpoint_path`` and ``pca_params_path``."""
    return 'checkpoint_path' in key or key == 'pca_params_path'


def _null_checkpoint_marker(args: Mapping[str, Any]) -> str:
    """What a null checkpoint key loads: CLIP's ``model_name=custom``
    loads the implicit :data:`CLIP_CUSTOM_CHECKPOINT` and keys on its
    content; everything else runs the seeded random init (``random``)."""
    if args.get('feature_type') == 'clip' and args.get('model_name') == 'custom' \
            and os.path.exists(CLIP_CUSTOM_CHECKPOINT):
        return f'file:{hash_file(CLIP_CUSTOM_CHECKPOINT)}'
    return 'random'


def weights_fingerprint(args: Mapping[str, Any], keys: Iterable[str]) -> str:
    """SHA-256 over the content of the file behind every
    :func:`is_file_key` key among ``keys``; a null checkpoint path
    contributes :func:`_null_checkpoint_marker`, a null PCA path
    ``none``. A configured file that cannot be read raises."""
    material = {k: (f'file:{hash_file(str(args[k]))}' if args.get(k)
                    else 'none' if k == 'pca_params_path'
                    else _null_checkpoint_marker(args))
                for k in sorted(keys) if is_file_key(k)}
    return hashlib.sha256(json.dumps(material, sort_keys=True).encode()
                          ).hexdigest()
