"""The feature cache as a two-level tier (the port's copy of
``video_features_tpu/fleet/tier.py``).

``cache_l2_dir`` turns the extractor's ``FeatureCache`` into a
:class:`TieredFeatureCache`:

  * **L1**: the host's own ``cache_dir``, the single-host store
    unchanged (this class is a ``FeatureCache`` over it: manifest,
    ``on_evict``, GC and stats keep their semantics);
  * **L2**: a directory every host mounts. A miss on host A for a video
    host B extracted is served from L2 byte-identically, with no decode
    and no step on the card, and promoted into A's L1 so the next hit
    is local.

Keys are content-addressed (video sha256 × run fingerprint × backend
tag), so two hosts publishing one key wrote identical bytes and
last-writer-wins atomic replace is safe; the manifest converges across
hosts as it does across processes. Integrity is checked at both levels
with the same size check: a torn or truncated L2 entry is evicted and
reads as a miss, never served. The L2 carries no eviction pressure from
extraction (``max_bytes=None``); ``python -m
video_features_torch.cache.gc`` on the shared directory bounds it.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Dict, Optional, Tuple

from video_features_torch.cache.store import FeatureCache, log_cache_error
from video_features_torch.utils.output import make_path


class TieredFeatureCache(FeatureCache):
    """Local-L1 ``FeatureCache`` with a shared-directory L2 behind it."""

    _pair_instances: Dict[Tuple[str, str], 'TieredFeatureCache'] = {}
    _pair_lock = threading.Lock()

    @classmethod
    def get_pair(cls, cache_dir: str, l2_dir: str,
                 max_bytes: Optional[int] = None) -> 'TieredFeatureCache':
        """The process-wide tier for an (L1, L2) directory pair — same
        sharing policy as :meth:`FeatureCache.get`, keyed on the pair
        because the L1 dir alone no longer names the behavior."""
        key = (os.path.abspath(os.path.expanduser(str(cache_dir))),
               os.path.abspath(os.path.expanduser(str(l2_dir))))
        with cls._pair_lock:
            inst = cls._pair_instances.get(key)
            if inst is None:
                inst = cls._pair_instances[key] = cls(
                    key[0], key[1], max_bytes=max_bytes)
            elif max_bytes is not None:
                inst.max_bytes = int(max_bytes)
            return inst

    def __init__(self, cache_dir: str, l2_dir: str,
                 max_bytes: Optional[int] = None) -> None:
        super().__init__(cache_dir, max_bytes=max_bytes)
        # the shared tier is a plain FeatureCache over the shared dir:
        # its atomic publish, manifest convergence, and integrity
        # checks are exactly the cross-process story, now cross-host
        self.l2 = FeatureCache.get(l2_dir)
        self.peer_hits = 0        # L1 miss served from L2
        self.l2_publishes = 0     # local puts replicated into L2

    # -- core operations -----------------------------------------------------

    def contains(self, key: str) -> bool:
        return super().contains(key) or self.l2.contains(key)

    def fetch_to(self, key: str, out_root: str, video_path: str,
                 fingerprint: Optional[str] = None) -> bool:
        """L1 first; on miss, serve the peer's L2 entry and PROMOTE it
        into L1 (the freshly materialized output files are the put
        sources, so promotion costs one local copy, never a decode).
        A promotion failure degrades to an un-promoted hit — the bytes
        were already served."""
        if super().fetch_to(key, out_root, video_path, fingerprint):
            return True
        if not self.l2.fetch_to(key, out_root, video_path, fingerprint):
            return False
        with self._lock:
            self.peer_hits += 1
        exts = self.l2.entry_exts(key)
        if exts:
            files = {okey: (make_path(out_root, video_path, okey, ext), ext)
                     for okey, ext in exts.items()}
            try:
                super().put(key, files,
                            meta={'promoted_from': self.l2.cache_dir})
            except Exception:
                log_cache_error(f'L1 promotion of {key}')
        return True

    def put(self, key: str, files: Dict[str, Tuple[str, str]],
            meta: Optional[Dict[str, Any]] = None) -> None:
        """Publish locally, then into the shared tier — so a peer's
        very next miss on this key is an L2 hit. An L2 publish failure
        (shared mount gone, quota) degrades to local-only and is
        reported; it must never fail the extraction that produced the
        bytes."""
        super().put(key, files, meta)
        try:
            self.l2.put(key, files, meta)
            with self._lock:
                self.l2_publishes += 1
        except Exception:
            log_cache_error(f'L2 publish of {key} ({self.l2.cache_dir})')

    # -- accounting ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        with self._lock:
            out['peer_hits'] = self.peer_hits
            out['l2_publishes'] = self.l2_publishes
        out['l2'] = self.l2.stats()
        return out
