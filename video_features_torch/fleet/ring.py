"""The consistent-hash ring behind fleet routing (the port's copy of
``video_features_tpu/fleet/ring.py``: the same points and owner order).

Classic virtual-node construction: every host hashes to ``replicas``
points on a 64-bit ring; a key routes to the first host point at or
after its own hash (wrapping). Properties the fleet relies on — and
the tests pin:

  * **determinism** — every router instance over the same host list
    computes the same assignment, with no coordination;
  * **minimal movement** — removing a host reassigns ONLY the keys it
    owned (~1/N of the space for N equal hosts); every other key keeps
    its backend, so its L1 cache and warm pools stay hot;
  * **stable failover order** — :meth:`hosts_for` walks the ring's
    successors, so "the next host" for a failed primary is the same
    host every router would pick, and retries concentrate a key's
    traffic on at most a couple of shards instead of spraying it.

Keys are strings (the video's content sha256 in practice); hosts are
opaque strings too (``host:port``). Hashing is sha256-derived rather
than ``hash()``: Python's string hash is salted per process, and a
ring that disagrees across processes would defeat the whole point.
"""
from __future__ import annotations

from bisect import bisect_right
from hashlib import sha256
from typing import Iterable, List, Sequence

DEFAULT_REPLICAS = 64


def _point(label: str) -> int:
    """A stable 64-bit ring coordinate for ``label``."""
    return int.from_bytes(sha256(label.encode('utf-8')).digest()[:8], 'big')


class HashRing:
    """An immutable consistent-hash ring over a static host list.

    Membership changes (a host drained, died, or was removed from
    ``fleet_hosts``) build a NEW ring — the structure is cheap (sorted
    list of ints) and immutability keeps the router's probe thread and
    request threads from ever seeing a half-updated ring.
    """

    def __init__(self, hosts: Sequence[str],
                 replicas: int = DEFAULT_REPLICAS) -> None:
        self.hosts: List[str] = list(dict.fromkeys(str(h) for h in hosts))
        self.replicas = int(replicas)
        points = []
        for host in self.hosts:
            for i in range(self.replicas):
                points.append((_point(f'{host}#{i}'), host))
        points.sort()
        self._points = [p for p, _ in points]
        self._owners = [h for _, h in points]

    def __len__(self) -> int:
        return len(self.hosts)

    def without(self, host: str) -> 'HashRing':
        """The ring minus ``host`` (same replica count)."""
        return HashRing([h for h in self.hosts if h != host],
                        replicas=self.replicas)

    def host_for(self, key: str) -> str:
        """The key's owner (first host clockwise of the key's point)."""
        if not self.hosts:
            raise ValueError('empty hash ring')
        i = bisect_right(self._points, _point(str(key)))
        if i == len(self._points):
            i = 0
        return self._owners[i]

    def hosts_for(self, key: str,
                  eligible: 'Iterable[str] | None' = None) -> List[str]:
        """Every distinct host in ring order starting at the key's
        owner — the router's failover sequence. ``eligible`` (when
        given) filters the walk to live hosts WITHOUT rebuilding the
        ring: a dead host is skipped, but the keys it owned all land on
        its ring successor (minimal movement), and every other key's
        owner is untouched."""
        if not self.hosts:
            return []
        allowed = None if eligible is None else set(eligible)
        start = bisect_right(self._points, _point(str(key)))
        out: List[str] = []
        seen = set()
        n = len(self._points)
        for off in range(n):
            host = self._owners[(start + off) % n]
            if host in seen:
                continue
            seen.add(host)
            if allowed is None or host in allowed:
                out.append(host)
            if len(seen) == len(self.hosts):
                break
        return out
