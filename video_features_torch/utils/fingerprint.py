"""Content hashes of the files a run reads (a jax-free copy of
``hash_file``, ``hash_file_stats`` and ``reset_hash_file_stats`` of
``video_features_tpu/cache/key.py``).

A video, a checkpoint or vggish's PCA file enters the run's identity by
its content, never its path: a file rewritten in place changes it, the
same bytes under a new path keep it. Hashes are memoized by ``(realpath,
size, mtime_ns)``, so a corpus read again (a fused worklist's families,
a second run in one process) pays the streaming read once per file
version; the counters say how many reads really ran.
"""
from __future__ import annotations

import hashlib
import os
import threading
from typing import Dict

_CHUNK = 1 << 20        # streaming-read granularity
# what CLIP's model_name=custom loads when no checkpoint_path is given
CLIP_CUSTOM_CHECKPOINT = './checkpoints/CLIP-custom.pth'

# (realpath, size, mtime_ns) → hex digest, bounded so a long process over
# a rotating corpus cannot grow it without limit
_HASH_MEMO: Dict[tuple, str] = {}
_HASH_MEMO_MAX = 65536
_MEMO_LOCK = threading.Lock()
# 'passes': streaming reads that ran; 'memo_hits': answers from the memo
_HASH_STATS = {'passes': 0, 'memo_hits': 0}


def hash_file_stats() -> Dict[str, int]:
    """The process-wide counters of :func:`hash_file`."""
    with _MEMO_LOCK:
        return dict(_HASH_STATS)


def reset_hash_file_stats() -> None:
    """Zero the counters; the memo is kept."""
    with _MEMO_LOCK:
        _HASH_STATS['passes'] = 0
        _HASH_STATS['memo_hits'] = 0


def hash_file(path: str) -> str:
    """Streaming SHA-256 of a file's content, memoized by its stat
    identity (a rewrite that changes the size or mtime re-hashes)."""
    real = os.path.realpath(path)
    st = os.stat(real)
    memo_key = (real, st.st_size, st.st_mtime_ns)
    with _MEMO_LOCK:
        hit = _HASH_MEMO.get(memo_key)
        if hit is not None:
            _HASH_STATS['memo_hits'] += 1
            return hit
    h = hashlib.sha256()
    with open(real, 'rb') as f:
        for chunk in iter(lambda: f.read(_CHUNK), b''):
            h.update(chunk)
    digest = h.hexdigest()
    with _MEMO_LOCK:
        _HASH_STATS['passes'] += 1
        if len(_HASH_MEMO) >= _HASH_MEMO_MAX:
            _HASH_MEMO.clear()
        _HASH_MEMO[memo_key] = digest
    return digest


def is_file_key(key: str) -> bool:
    """True for the config keys whose file enters the fingerprint by its
    content: every ``*checkpoint_path`` and ``pca_params_path``."""
    return 'checkpoint_path' in key or key == 'pca_params_path'
