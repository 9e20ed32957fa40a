"""Cache-key derivation: what makes two extractions the same work (the
port's copy of ``video_features_tpu/cache/key.py``).

For a fixed video, family, config and checkpoint the outputs are
deterministic, so a result is identified by

    (video content hash, config fingerprint, weights fingerprint)

and the cache key is one SHA-256 over them, with a backend tag. Each
part aims at no false hit first and few false misses second:

  * the video enters by its content (``utils.fingerprint.hash_file``),
    so one clip under ten names is one entry;
  * the config fingerprint takes every key except those
    ``config.knob_exclude('fingerprint')`` names (output paths, device
    and parallelism, profiling, the ``cache_*`` keys) and the file keys:
    a knob nobody classified stays in, and costs a miss, never a wrong
    hit;
  * the weights fingerprint hashes the content of every checkpoint file
    and of vggish's PCA file (the JAX package keys the PCA file by its
    path string: the port's rule is the stricter one, on purpose).

:func:`run_fingerprint` is also what every resume sidecar records.
Outputs of the port and of the JAX package agree to about 1e-3, not to
the byte, so :func:`video_cache_key` mixes in :data:`BACKEND_TAG`: an
entry one package wrote never answers the other, even in a shared store.
"""
from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, Mapping

from video_features_torch.config import knob_exclude
from video_features_torch.utils.fingerprint import (
    CLIP_CUSTOM_CHECKPOINT, hash_file, hash_file_stats, is_file_key,
    reset_hash_file_stats,
)

__all__ = ('BACKEND_TAG', 'CONFIG_KEY_EXCLUDE', 'config_fingerprint',
           'hash_file', 'hash_file_stats', 'reset_hash_file_stats',
           'run_fingerprint', 'video_cache_key', 'weights_fingerprint')

CONFIG_KEY_EXCLUDE = knob_exclude('fingerprint')
BACKEND_TAG = 'torch'


def _canonical(obj: Any) -> str:
    """Deterministic serialization: ``repr`` for non-JSON values, sorted
    keys."""
    return json.dumps(obj, sort_keys=True, default=repr)


def config_fingerprint(args: Mapping[str, Any]) -> str:
    """SHA-256 over the keys of a merged config that can change the
    outputs. An absent or null ``compute_dtype`` is the float32 lane."""
    relevant = {k: v for k, v in args.items()
                if k not in CONFIG_KEY_EXCLUDE and not is_file_key(k)}
    if relevant.get('compute_dtype') is None:
        relevant['compute_dtype'] = 'float32'
    return hashlib.sha256(_canonical(relevant).encode()).hexdigest()


def _null_checkpoint_marker(args: Mapping[str, Any]) -> str:
    """What a null checkpoint key loads: CLIP's ``model_name=custom``
    loads the implicit :data:`CLIP_CUSTOM_CHECKPOINT` and keys on its
    content; everything else runs the seeded random init (``random``).
    The port never loads pip timm's pretrained weights, so timm has no
    marker of its own."""
    if args.get('feature_type') == 'clip' and args.get('model_name') == 'custom' \
            and os.path.exists(CLIP_CUSTOM_CHECKPOINT):
        return f'file:{hash_file(CLIP_CUSTOM_CHECKPOINT)}'
    return 'random'


def weights_fingerprint(args: Mapping[str, Any]) -> str:
    """SHA-256 over the content of the file behind every file key of
    ``args`` (``utils.fingerprint.is_file_key``); a null checkpoint path
    contributes :func:`_null_checkpoint_marker`, a null PCA path
    ``none``. A configured file that cannot be read raises."""
    material: Dict[str, str] = {
        k: (f'file:{hash_file(str(args[k]))}' if args[k]
            else 'none' if k == 'pca_params_path'
            else _null_checkpoint_marker(args))
        for k in sorted(args) if is_file_key(k)}
    return hashlib.sha256(_canonical(material).encode()).hexdigest()


def run_fingerprint(args: Mapping[str, Any]) -> str:
    """The one identity of an extraction recipe: the config fingerprint
    and the weights fingerprint. Resume sidecars record it; the cache
    key combines it with the video's content."""
    return hashlib.sha256(
        f'cfg:{config_fingerprint(args)}|w:{weights_fingerprint(args)}'
        .encode()).hexdigest()


def video_cache_key(video_path: str, fingerprint: str, segment=None) -> str:
    """The store key of one (video, recipe) pair. ``segment``, a
    ``(start_s, end_s)`` range, keys a partial extraction apart from the
    whole video, quantized to milliseconds as the output names are."""
    seg = ''
    if segment is not None:
        start_s, end_s = segment
        seg = (f'|seg:{int(round(float(start_s) * 1000))}'
               f'-{int(round(float(end_s) * 1000))}')
    return hashlib.sha256(
        f'{fingerprint}|video:{hash_file(video_path)}{seg}'
        f'|backend:{BACKEND_TAG}'.encode()).hexdigest()
