"""The executable store as the fleet's shared artifact tier (the port's
copy of ``video_features_tpu/fleet/artifacts.py``).

``aot_l2_dir`` turns the extractor's ``ExecStore`` into a
:class:`TieredExecStore`: the host's own ``aot_dir`` stays the L1 (this
class is an ``ExecStore`` over it) and a directory every fleet host
mounts becomes the shared tier behind it. Two hosts with matching
environments compute the same digest for the same kernel library
(``aot/runtime.py``), so with no coordination:

  * **publish-on-compile**: a build anywhere in the fleet lands the
    library's bytes in the shared tier (local put, then shared put, both
    idempotent atomic replaces);
  * **pull-on-miss**: a fresh host's first fetch misses its empty L1,
    hits the shared tier, re-publishes the payload locally under the
    peer's recorded meta, and runs no ``nvcc``;
  * **silent rebuild on drift**: a host whose environment differs
    computes a digest nothing published and builds as it always did;
    ``metas_for`` still shows the near miss to the drift event.

Counters fold into the ``vft_aot_*`` families: the tier's stats are the
L1 stats plus ``pulled`` / ``published`` and an ``l2`` sub-document.
Integrity: :meth:`TieredExecStore.fetch` checks each tier's payload
against the size and sha256 that tier recorded. A bad L1 payload is
evicted from L1 alone and the fetch pulls the good copy from L2 (the
JAX tier purges both tiers when its L1 copy fails the size check); a
pulled payload that fails is evicted from the shared tier and never
re-published locally, so a poisoned shared entry cannot re-poison every
cold host. ``evict_corrupt`` (a caller's report) purges both tiers, as
in the JAX package. The shared tier carries no
inline eviction pressure (``max_bytes=None``); ``python -m
video_features_torch aot-gc`` against the shared directory bounds it.
"""
from __future__ import annotations

import os
import threading
from typing import Any, Callable, Dict, Optional, Tuple

from video_features_torch.aot.store import ExecStore, log_aot_error


class TieredExecStore(ExecStore):
    """Local-L1 ``ExecStore`` with a shared artifact tier behind it."""

    _pair_instances: Dict[Tuple[str, str], 'TieredExecStore'] = {}
    _pair_lock = threading.Lock()

    @classmethod
    def get_pair(cls, aot_dir: str, l2_dir: str,
                 max_bytes: Optional[int] = None) -> 'TieredExecStore':
        """The process-wide tier for an (L1, shared) directory pair —
        same sharing policy as :meth:`ExecStore.get`."""
        key = (os.path.abspath(os.path.expanduser(str(aot_dir))),
               os.path.abspath(os.path.expanduser(str(l2_dir))))
        with cls._pair_lock:
            inst = cls._pair_instances.get(key)
            if inst is None:
                inst = cls._pair_instances[key] = cls(
                    key[0], key[1], max_bytes=max_bytes)
            elif max_bytes is not None:
                inst.max_bytes = int(max_bytes)
            return inst

    def __init__(self, aot_dir: str, l2_dir: str,
                 max_bytes: Optional[int] = None) -> None:
        super().__init__(aot_dir, max_bytes=max_bytes)
        self.l2 = ExecStore.get(l2_dir)
        self.pulled = 0           # L1 miss served from the shared tier
        self.published = 0        # local puts replicated into it

    # -- core operations -----------------------------------------------------

    def contains(self, digest: str) -> bool:
        return super().contains(digest) or self.l2.contains(digest)

    def metas_for(self, program_sha: str) -> list:
        """Union of both tiers (deduplicated) — a cold host's drift
        diagnostics must see what the FLEET holds for the program, not
        its own empty L1."""
        seen = []
        for meta in super().metas_for(program_sha) \
                + self.l2.metas_for(program_sha):
            if meta not in seen:
                seen.append(meta)
        return seen

    def fetch(self, digest: str,
              on_corrupt: Optional[Callable[[str], None]] = None,
              ) -> Optional[bytes]:
        """L1 first; on miss, pull from the shared tier and re-publish
        locally under the peer's recorded meta (pull-on-miss). Each tier
        checks its payload against the record it holds: a bad L1 payload
        is evicted from L1 alone and the fetch goes on to the shared
        tier; a pulled payload that fails is evicted there and never
        reaches L1. A failed local re-publish degrades to serving the
        pulled bytes — the next boot pulls again."""
        payload = super().fetch(digest, on_corrupt)
        if payload is not None:
            return payload
        payload = self.l2.fetch(digest, on_corrupt)
        if payload is None:
            return None
        with self._lock:
            self.pulled += 1
        try:
            super().put(digest, payload, meta=self.l2.meta_for(digest))
        except Exception:
            log_aot_error(f'local re-publish of pulled {digest[:12]}')
        return payload

    def put(self, digest: str, payload: bytes,
            meta: Optional[Dict[str, Any]] = None) -> None:
        """Publish locally, then into the shared tier
        (publish-on-compile). A shared publish failure degrades to
        local-only and is reported — it must never fail the build that
        produced the executable."""
        super().put(digest, payload, meta)
        try:
            self.l2.put(digest, payload, meta)
            with self._lock:
                self.published += 1
        except Exception:
            log_aot_error(f'shared publish of {digest[:12]} '
                          f'({self.l2.aot_dir})')

    def evict_corrupt(self, digest: str) -> None:
        """Purge both tiers: a payload its caller found bad was
        byte-identical in each, and leaving the shared copy would
        re-poison every cold host that pulls it."""
        super().evict_corrupt(digest)
        try:
            self.l2.evict_corrupt(digest)
        except Exception:
            log_aot_error(f'shared corrupt-evict of {digest[:12]}')

    # -- accounting ----------------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        out = super().stats()
        with self._lock:
            out['pulled'] = self.pulled
            out['published'] = self.published
        out['l2'] = self.l2.stats()
        return out
