"""API-key tenancy for the ingress (the port's copy of
``video_features_tpu/ingress/auth.py``).

Keys live in a config-pointed file (``serve_ingress_auth_file``) — JSON
or YAML, reloaded only at startup (key rotation = restart/SIGHUP the
daemon; a file watch on a secrets file is more machinery than a front
door needs). Two accepted shapes::

    {"keys": {"<api-key>": {"tenant": "acme",
                            "priority": "interactive",
                            "rate_rps": 50, "burst": 100,
                            "max_concurrent": 8}}}

or the flat form ``{"<api-key>": {...}}``. Every field but ``tenant``
is optional: ``priority`` defaults to ``interactive``, a null/absent
``rate_rps`` means unlimited, ``max_concurrent`` defaults to unlimited.

Requests authenticate with ``Authorization: Bearer <key>`` or
``X-API-Key: <key>``. Key comparison is constant-time
(``hmac.compare_digest``) — the keys ARE the secret, and a timing
oracle on a network endpoint is a real leak.
"""
from __future__ import annotations

import hmac
from typing import Dict, Mapping, Optional

# the one canonical priority vocabulary (the server validates submits
# against it); re-exported here for auth-file validation
from video_features_torch.serve.protocol import PRIORITIES


class Tenant:
    """One API key's identity + policy (immutable after load)."""

    __slots__ = ('name', 'priority', 'rate_rps', 'burst', 'max_concurrent')

    def __init__(self, name: str, priority: str = 'interactive',
                 rate_rps: Optional[float] = None,
                 burst: Optional[float] = None,
                 max_concurrent: Optional[int] = None) -> None:
        if priority not in PRIORITIES:
            raise ValueError(
                f'tenant {name!r}: priority must be one of {PRIORITIES}; '
                f'got {priority!r}')
        self.name = str(name)
        self.priority = priority
        self.rate_rps = None if rate_rps is None else float(rate_rps)
        if self.rate_rps is not None and self.rate_rps <= 0:
            raise ValueError(f'tenant {name!r}: rate_rps must be > 0')
        # default burst: one second of rate (min 1) — a keyless knob
        # most operators never need to touch
        self.burst = (float(burst) if burst is not None
                      else max(self.rate_rps or 1.0, 1.0))
        self.max_concurrent = (None if max_concurrent is None
                               else int(max_concurrent))
        if self.max_concurrent is not None and self.max_concurrent < 0:
            raise ValueError(
                f'tenant {name!r}: max_concurrent must be >= 0')


class ApiKeyAuth:
    """The key table + header authentication."""

    def __init__(self, keys: Mapping[str, Tenant]) -> None:
        self._keys: Dict[str, Tenant] = dict(keys)
        if not self._keys:
            raise ValueError('auth file defines no API keys')

    @classmethod
    def from_file(cls, path: str) -> 'ApiKeyAuth':
        import yaml
        with open(path, encoding='utf-8') as f:
            doc = yaml.safe_load(f) or {}
        if not isinstance(doc, dict):
            raise ValueError(f'auth file {path} must be a mapping')
        table = doc.get('keys', doc)
        if not isinstance(table, dict):
            raise ValueError(f'auth file {path}: "keys" must be a mapping')
        keys: Dict[str, Tenant] = {}
        for key, spec in table.items():
            spec = dict(spec or {})
            tenant = spec.pop('tenant', None)
            if not tenant:
                raise ValueError(
                    f'auth file {path}: key {str(key)[:6]}… has no tenant')
            unknown = set(spec) - {'priority', 'rate_rps', 'burst',
                                   'max_concurrent'}
            if unknown:
                raise ValueError(
                    f'auth file {path}: tenant {tenant!r} has unknown '
                    f'fields {sorted(unknown)}')
            keys[str(key)] = Tenant(tenant, **spec)
        # several keys may share one tenant — and then they SHARE its
        # quota ledger (ingress/quota.py keys state by tenant name), so
        # their policies must agree or the effective policy would be
        # whichever key happened to authenticate first after startup
        by_tenant: Dict[str, tuple] = {}
        for t in keys.values():
            policy = (t.priority, t.rate_rps, t.burst, t.max_concurrent)
            prior = by_tenant.setdefault(t.name, policy)
            if prior != policy:
                raise ValueError(
                    f'auth file {path}: keys for tenant {t.name!r} carry '
                    'conflicting policies (priority/rate_rps/burst/'
                    'max_concurrent must match across a tenant\'s keys '
                    '— they share one quota ledger)')
        return cls(keys)

    @property
    def n_tenants(self) -> int:
        return len({t.name for t in self._keys.values()})

    def authenticate(self, headers: Mapping[str, str]) -> Optional[Tenant]:
        """The tenant behind this request's credentials, or None."""
        key = None
        bearer = headers.get('authorization', '')
        if bearer.lower().startswith('bearer '):
            key = bearer[7:].strip()
        if not key:
            key = headers.get('x-api-key', '').strip()
        if not key:
            return None
        for known, tenant in self._keys.items():
            if hmac.compare_digest(known.encode(), key.encode()):
                return tenant
        return None
