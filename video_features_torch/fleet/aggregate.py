"""Fleet-wide Prometheus aggregation: scrape → relabel → merge (the
port's copy of ``video_features_tpu/fleet/aggregate.py``).

One scrape target for the whole fleet: the router asks every backend
for its own exposition text (the ``metrics_prom`` command each daemon
already serves), injects a ``host="<addr>"`` label into every sample
so per-host series stay distinguishable after the merge, regroups the
``# HELP`` / ``# TYPE`` headers so each family appears ONCE, and
appends the router's own ``vft_fleet_*`` / ``vft_slo_*`` families.
A Prometheus agent then needs a single target (the router's
``/metrics`` route) instead of N backend addresses that churn as the
fleet scales — exactly the "metrics already exported" surface ROADMAP
item 2's elastic membership consumes.

Two deliberate properties:

  * **Scrapes ride the probe deadline.** A backend that accepts and
    never answers must cost the aggregate half a second, not wedge the
    fleet's only scrape target — same hard-deadline policy (and the
    same raw-socket shape) as the router's health probe.
  * **Staleness is explicit, not implicit.** A backend that fails its
    scrape contributes NO samples (its last values are never replayed
    as if fresh); the router's ``vft_fleet_backend_up`` /
    ``vft_fleet_probe_age_seconds`` gauges say which hosts are missing
    and how old their last probe is.

Merging happens at the TEXT level — the backends' exposition is parsed
line-wise, not re-ingested into a registry — so histogram bucket
layouts, counter monotonicity, and escaping survive byte-for-byte from
each daemon; the only rewrite is the injected ``host`` label.
"""
from __future__ import annotations

import re
from typing import Dict, List, Mapping, Optional

from video_features_torch.obs.metrics import _escape
from video_features_torch.serve import protocol

# one exposition sample line: name, optional {labels}, value (and an
# optional timestamp) kept verbatim in `rest`
_SAMPLE_RE = re.compile(
    r'^(?P<name>[a-zA-Z_:][a-zA-Z0-9_:]*)'
    r'(?:\{(?P<labels>.*)\})?'
    r'(?P<rest>\s.+)$')

# sample-name suffixes that belong to a histogram/summary family whose
# HELP/TYPE headers carry the BASE name
_FAMILY_SUFFIXES = ('_bucket', '_sum', '_count')


def scrape_prom(host: str, port: int, timeout_s: float) -> str:
    """One backend's exposition text under a HARD deadline (connect and
    read) — the router's probe-call shape, because ``ServeClient``
    leaves reads unbounded and the fleet's one scrape target must not
    inherit a wedged backend's patience."""
    import socket
    with socket.create_connection((host, port),
                                  timeout=timeout_s) as conn:
        conn.settimeout(timeout_s)
        conn.sendall(protocol.encode({'cmd': protocol.CMD_METRICS_PROM,
                                      'v': protocol.VERSION}))
        with conn.makefile('rb') as rfile:
            line = rfile.readline()
    if not line:
        raise ConnectionError('backend closed the metrics connection')
    resp = protocol.decode(line)
    if not resp.get('ok'):
        raise ValueError(f'metrics_prom failed: {resp.get("error")}')
    return str(resp.get('text') or '')


def _family_of(sample_name: str, types: Dict[str, str]) -> str:
    """The family a sample line belongs to: its own name, or — for
    ``_bucket``/``_sum``/``_count`` suffixes whose base name has a
    declared histogram/summary TYPE — the base name."""
    for suffix in _FAMILY_SUFFIXES:
        if sample_name.endswith(suffix):
            base = sample_name[:-len(suffix)]
            if types.get(base) in ('histogram', 'summary'):
                return base
    return sample_name


def merge_expositions(per_host: Mapping[str, Optional[str]]) -> str:
    """Merge per-backend exposition texts into one, every sample
    relabeled with ``host=<addr>``.

    ``per_host`` maps backend addr → its scraped text, or ``None`` for
    a host whose scrape failed (it contributes nothing — staleness is
    reported by the router's own gauges, not by replaying old values).
    Families are emitted once each (first host's HELP/TYPE wins; the
    daemons all render the same registry code, so headers agree),
    sorted by name for a stable scrape; within a family, samples keep
    per-host order. Returns '' when nothing was scraped.
    """
    # family → {'help': line|None, 'type': line|None, 'samples': [...]}
    families: Dict[str, Dict[str, object]] = {}

    def fam(name: str) -> Dict[str, object]:
        f = families.get(name)
        if f is None:
            f = families[name] = {'help': None, 'type': None,
                                  'samples': []}
        return f

    for host, text in per_host.items():
        if not text:
            continue
        host_label = f'host="{_escape(host)}"'
        types: Dict[str, str] = {}
        for raw in text.splitlines():
            line = raw.rstrip()
            if not line:
                continue
            if line.startswith('# HELP '):
                parts = line.split(' ', 3)
                if len(parts) >= 3 and fam(parts[2])['help'] is None:
                    fam(parts[2])['help'] = line
                continue
            if line.startswith('# TYPE '):
                parts = line.split(' ', 3)
                if len(parts) >= 4:
                    types[parts[2]] = parts[3]
                    if fam(parts[2])['type'] is None:
                        fam(parts[2])['type'] = line
                continue
            if line.startswith('#'):
                continue                       # free-form comment
            m = _SAMPLE_RE.match(line)
            if m is None:
                continue                       # not exposition — drop
            labels = m.group('labels')
            merged = host_label if not labels else \
                f'{host_label},{labels}'
            name = m.group('name')
            fam(_family_of(name, types))['samples'].append(
                f'{name}{{{merged}}}{m.group("rest")}')

    lines: List[str] = []
    for name in sorted(families):
        f = families[name]
        if not f['samples']:
            continue                           # headers with no data
        if f['help']:
            lines.append(str(f['help']))
        if f['type']:
            lines.append(str(f['type']))
        lines.extend(f['samples'])             # type: ignore[arg-type]
    return '\n'.join(lines) + '\n' if lines else ''
