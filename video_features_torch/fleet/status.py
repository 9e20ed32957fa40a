"""One-look fleet health: the router's per-backend table as text (the
port's counterpart of ``tools/fleet_status.py``, with the same rows and
exit codes).

Connects to a fleet router's loopback port (``fleet`` command), asks for
its metrics document, and prints one row per configured backend —
health, PROBE FRESHNESS (``age_s``: seconds since the last probe, so a
stale last-good row is distinguishable from a live healthy backend),
drain state, live queue depth, cache hit rate, and warm-pool build
counters — plus the router's own routing/failover counters. The same
document backs the router's HTTP ``GET /v1/metrics``; this tool is the
no-auth operator surface for the loopback deployment shape.

Usage:
    python -m video_features_torch.fleet.status [--host 127.0.0.1] \\
        --port 9310 [--json]

Exit codes (monitorable — cron/CI can alert on them):
    0  every configured backend is healthy and not draining
    1  degraded — at least one backend is unhealthy or draining, but
       the fleet still has an eligible backend
    2  down — no eligible backend at all, or the router itself is
       unreachable
"""
from __future__ import annotations

import argparse
import json
import sys


def _fmt(value, width: int, suffix: str = '') -> str:
    if value is None:
        return '-'.rjust(width)
    if isinstance(value, float):
        return f'{value:.2f}{suffix}'.rjust(width)
    return f'{value}{suffix}'.rjust(width)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog='python -m video_features_torch.fleet.status',
        description="Print a fleet router's per-backend health table.")
    ap.add_argument('--host', default='127.0.0.1',
                    help='the router host (default: loopback)')
    ap.add_argument('--port', type=int, required=True,
                    help='the router loopback port (fleet_port)')
    ap.add_argument('--timeout-s', type=float, default=5.0,
                    help='connect deadline for reaching the router')
    ap.add_argument('--json', action='store_true',
                    help='print the raw fleet metrics document instead '
                         'of the table')
    ns = ap.parse_args(argv)

    from video_features_torch.serve.client import ServeClient, ServeError
    try:
        doc = ServeClient(ns.port, host=ns.host,
                          connect_timeout_s=ns.timeout_s).metrics()
    except (ServeError, OSError) as e:
        print(f'error: router at {ns.host}:{ns.port} unreachable: {e}',
              file=sys.stderr)
        return 2
    fleet = doc.get('fleet')
    if not isinstance(fleet, dict):
        print(f'error: {ns.host}:{ns.port} answered metrics without a '
              f'fleet section — is that a serve daemon, not a router?',
              file=sys.stderr)
        return 2

    if ns.json:
        print(json.dumps(fleet, sort_keys=True))
    else:
        routed = fleet.get('routed') or {}
        print(f"fleet router {ns.host}:{ns.port}  "
              f"uptime={fleet.get('uptime_s')}s  "
              f"draining={fleet.get('draining')}  "
              f"failovers={fleet.get('failovers')}  "
              f"rejected={fleet.get('rejected')}")
        header = (f"{'backend':24} {'health':>9} {'age_s':>6} "
                  f"{'drain':>5} {'queue':>5} {'hit%':>6} "
                  f"{'compiled':>8} {'loaded':>6} {'routed':>7}  "
                  f"last_error")
        print(header)
        for addr, row in sorted((fleet.get('backends') or {}).items()):
            hit = row.get('cache_hit_rate')
            print(f"{addr:24} "
                  f"{'healthy' if row.get('healthy') else 'DOWN':>9} "
                  f"{_fmt(row.get('probe_age_s'), 6)} "
                  f"{'yes' if row.get('draining') else 'no':>5} "
                  f"{_fmt(row.get('queue_depth'), 5)} "
                  f"{_fmt(None if hit is None else 100 * hit, 6)} "
                  f"{_fmt(row.get('builds_compiled'), 8)} "
                  f"{_fmt(row.get('builds_loaded'), 6)} "
                  f"{_fmt(routed.get(addr), 7)}  "
                  f"{row.get('last_error') or ''}")

    backends = fleet.get('backends') or {}
    eligible = fleet.get('eligible') or []
    if not eligible:
        return 2
    degraded = any(not row.get('healthy') or row.get('draining')
                   for row in backends.values())
    return 1 if degraded else 0


if __name__ == '__main__':
    raise SystemExit(main())
