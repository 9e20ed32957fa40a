"""Per-tenant quotas: token-bucket rate limits + concurrent requests
(the port's copy of ``video_features_tpu/ingress/quota.py``).

Two independent gates, both checked BEFORE the serve admission gate so
a quota-shed request never touches — let alone occupies — an admission
slot:

  * the token bucket bounds sustained request RATE (``rate_rps`` tokens
    per second, ``burst`` capacity): classic leaky-bucket arithmetic,
    refilled lazily on each acquire, no timers;
  * the concurrency gate bounds how many of a tenant's extraction
    requests (live sessions included) are IN FLIGHT at once — acquired
    at submit, released when the request reaches a terminal state (the
    gateway listens on ``ExtractionServer.completion_listeners``).

Thread safety: one lock per tenant record; the acquire path is a few
float ops. The manager's snapshot feeds the serve metrics document's
``ingress.tenants`` section.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Tuple

from video_features_torch.ingress.auth import Tenant


class TokenBucket:
    """Lazy-refill token bucket. ``rate=None`` = unlimited."""

    def __init__(self, rate: Optional[float], burst: float) -> None:
        self.rate = rate
        self.burst = float(burst)
        self.tokens = float(burst)
        self._t_last = time.monotonic()

    def try_acquire(self, n: float = 1.0) -> bool:
        if self.rate is None:
            return True
        now = time.monotonic()
        self.tokens = min(self.burst,
                          self.tokens + (now - self._t_last) * self.rate)
        self._t_last = now
        if self.tokens >= n:
            self.tokens -= n
            return True
        return False


class _TenantState:
    __slots__ = ('tenant', 'bucket', 'inflight', 'lock',
                 'requests', 'shed')

    def __init__(self, tenant: Tenant) -> None:
        self.tenant = tenant
        self.bucket = TokenBucket(tenant.rate_rps, tenant.burst)
        self.inflight = 0
        self.lock = threading.Lock()
        self.requests = 0          # accepted
        self.shed = 0              # rejected by either gate


class QuotaManager:
    """All tenants' quota state, keyed by tenant name (several API keys
    may map onto one tenant and share its budget)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._states: Dict[str, _TenantState] = {}

    def _state(self, tenant: Tenant) -> _TenantState:
        with self._lock:
            st = self._states.get(tenant.name)
            if st is None:
                st = self._states[tenant.name] = _TenantState(tenant)
            return st

    def acquire(self, tenant: Tenant) -> Tuple[bool, Optional[str]]:
        """(admitted, shed_reason): ``rate_limited`` when the bucket is
        dry, ``concurrency`` when the tenant's in-flight budget is
        spent. On success the caller OWNS one concurrency unit until
        :meth:`release`."""
        st = self._state(tenant)
        with st.lock:
            # concurrency BEFORE the bucket: a concurrency shed must not
            # debit a rate token, or retries against a full in-flight
            # budget would starve the tenant's rate budget too
            limit = tenant.max_concurrent
            if limit is not None and st.inflight >= limit:
                st.shed += 1
                return False, 'concurrency'
            if not st.bucket.try_acquire():
                st.shed += 1
                return False, 'rate_limited'
            st.inflight += 1
            st.requests += 1
            return True, None

    def release(self, tenant_name: str) -> None:
        with self._lock:
            st = self._states.get(tenant_name)
        if st is None:
            return
        with st.lock:
            st.inflight = max(0, st.inflight - 1)

    def count_shed(self, tenant: Tenant) -> None:
        """Record a shed that happened DOWNSTREAM of the quota gates
        (priority-class admission rejection) against the tenant."""
        st = self._state(tenant)
        with st.lock:
            st.shed += 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            states = list(self._states.values())
        out: Dict[str, Dict[str, float]] = {}
        for st in states:
            with st.lock:
                out[st.tenant.name] = {
                    'priority': st.tenant.priority,
                    'inflight': st.inflight,
                    'requests': st.requests,
                    'shed': st.shed,
                }
        return out
