"""Wire protocol for the warm-pool extraction service: JSON lines over a
local TCP socket (the port's copy of ``video_features_tpu/serve/
protocol.py``: the same wire, version and command names, so a client of
either daemon talks to both).

One request per line, one response per line, UTF-8, newline-delimited —
the simplest framing that composes with ``socket.makefile`` buffering,
survives partial reads, and stays debuggable with ``nc``/``telnet``. The
endpoint binds loopback only; this is a LOCAL control surface (same
trust domain as the process), not an internet-facing API.

Versioning: every message MAY carry a ``v`` field (``'<major>.<minor>'``;
:data:`VERSION` is what this build speaks, :data:`MAJOR` the compatible
major). A missing ``v`` is treated as v1 (pre-versioning clients keep
working); an unknown MAJOR is rejected with a structured error that
echoes the message's ``request_id`` (when present) instead of a silent
parse failure — see :func:`check_version`. Minor-version skew is always
accepted (additive fields only).

Commands (the ``cmd`` field):

  * ``submit``  — ``{cmd, feature_type, video_paths: [..],
    overrides: {..}, timeout_s, range: [start_s, end_s], priority}`` →
    ``{ok, request_id}`` or ``{ok: false, error}``. ``overrides`` merge
    over the server's base overrides and the feature YAML exactly like
    CLI dotlist keys. ``range`` (optional) makes this a SEGMENT query:
    only the windows overlapping the time range are decoded/extracted,
    and outputs are named ``<stem>_seg<start>-<end>ms``. ``priority``
    (``interactive``, the default, or ``batch``) feeds admission
    control: a saturated queue sheds ``batch`` before ``interactive``.
    ``traceparent`` (optional, W3C ``00-<trace>-<span>-<flags>``) joins
    the request to a caller-owned distributed trace; absent or
    malformed, the server mints one. The submit response echoes the
    ``trace_id`` either way. ``features`` (optional, v1.2) submits a
    FUSED multi-family request: one umbrella request id plus a
    ``requests`` map of per-family child ids in the response
    (``feature_type`` is ignored when present); family-scoped override
    keys spell ``<family>.<knob>``.
  * ``status``  — ``{cmd, request_id}`` → per-request state + per-video
    states (see ``serve.server.Request.snapshot``).
  * ``trace``   — ``{cmd, request_id}`` → ``{ok, request_id, trace_id,
    events}``: the request's assembled span timeline, filtered from the
    live recorders (``serve.server.ExtractionServer.request_trace``).
    Against the FLEET ROUTER (v1.5) the assembly is scatter-gather —
    router spans plus every attempted backend's spans merged ts-sorted
    under one trace_id, with per-event ``host`` attrs and an additive
    ``hosts`` response field listing the contributors.
  * ``metrics`` — ``{cmd}`` → the live metrics document
    (``docs/serving.md`` schema; v1.5 adds the ``slo`` section).
  * ``metrics_prom`` — ``{cmd}`` → ``{ok, text}``: the same state as
    Prometheus text exposition format 0.0.4 (``docs/observability.md``).
    Against the FLEET ROUTER (v1.5): the fleet-aggregated exposition —
    every backend's families relabeled ``host=`` and merged with the
    router's ``vft_fleet_*`` / ``vft_slo_*`` families.
  * ``search`` — (v1.3) query the feature index. By vector:
    ``{cmd, family, vector: [..], k}``; by video: ``{cmd, video_path,
    features: [..], k, timeout_s}`` (extracts through the fused submit
    path, waits for ingest, queries with the video's own windows) →
    ``{ok, hits | results}`` with per-hit ``{score, video,
    video_sha256, t_ms, key, family}``. Requires ``index_enabled``.
  * ``index_status`` — (v1.3) ``{cmd}`` → the index section of the
    metrics document (rows, shards, ingest lag, program residency).
  * ``drain``   — stop admitting, finish everything queued, shut down.
  * ``ping``    — liveness probe.
"""
from __future__ import annotations

import json
from typing import Any, Dict

# command-name constants: the one spelling of each command; the server's
# dispatch and ServeClient build their messages from these. The port
# answers ``search`` and ``index_status`` with a structured refusal (no
# ``index/`` yet).
CMD_SUBMIT = 'submit'
CMD_STATUS = 'status'
CMD_TRACE = 'trace'
CMD_METRICS = 'metrics'
CMD_METRICS_PROM = 'metrics_prom'
CMD_SEARCH = 'search'
CMD_INDEX_STATUS = 'index_status'
CMD_DRAIN = 'drain'
CMD_PING = 'ping'

COMMANDS = (CMD_SUBMIT, CMD_STATUS, CMD_TRACE, CMD_METRICS,
            CMD_METRICS_PROM, CMD_SEARCH, CMD_INDEX_STATUS, CMD_DRAIN,
            CMD_PING)

# wire protocol version this build speaks; MAJOR is the compatibility
# gate (minor bumps are additive-fields-only and never rejected).
# History: 1.0 introduced versioning itself (check_version + client `v`
# stamping); 1.1 is the first real MINOR bump, retroactively covering
# the additive `trace` command / `/v1/requests/<id>/trace` route that
# landed without a bump — exactly the drift WIRE.lock.json now catches;
# 1.2 adds the optional `features` submit field (fused multi-family
# requests: one request id, per-family children, `requests`/`errors`
# in the response and nested per-family `videos` in status);
# 1.3 adds the feature-index surface: the `search` / `index_status`
# commands and the ingress `POST /v1/search` route (query-by-vector
# and query-by-video over the sharded embedding index);
# 1.4 adds the additive `code` field on error responses (the ERR_*
# constants below): the fleet router's failover decision — retry the
# hash ring's next host vs propagate to the caller — keys on the code,
# never on the human-readable message text;
# 1.5 (vft-scope) adds the fleet observability plane, all additive:
# the router answers `metrics_prom` with the fleet-aggregated
# exposition (host-relabeled backend families + vft_fleet_*/vft_slo_*),
# its `trace` response gains `hosts` and per-event `host` attrs
# (cross-host scatter-gather assembly), and the metrics document gains
# the `slo` section (burn-rate objectives, obs/slo.py).
VERSION = '1.5'
MAJOR = 1

# submit() fields copied verbatim into the request (everything else in the
# message is rejected — catches client/server schema drift loudly)
SUBMIT_FIELDS = ('cmd', 'v', 'feature_type', 'video_paths', 'overrides',
                 'timeout_s', 'range', 'priority', 'traceparent',
                 'features')

PRIORITIES = ('interactive', 'batch')

# structured error codes (wire 1.4, the additive `code` response field).
# Server-side rejections carry one of the first group; the CLIENT mints
# the second group for failures that never reached a server response, so
# one switch in the router covers both. Failover semantics
# (fleet/router.py): `shed`, `connect_refused`, and `deadline` are
# retry-next-host; everything else propagates to the caller — a request
# the whole fleet would reject identically must not be retried N times.
ERR_SHED = 'shed'                      # queue_full / draining admission
ERR_INVALID = 'invalid'                # malformed or unknown-field request
ERR_UNSUPPORTED = 'unsupported'        # version skew / disabled subsystem
ERR_NOT_FOUND = 'not_found'            # unknown request_id
ERR_INTERNAL = 'internal'              # handler raised
ERR_CONNECT_REFUSED = 'connect_refused'  # client-minted: no listener
ERR_DEADLINE = 'deadline'              # client-minted: timed out waiting


def encode(msg: Dict[str, Any]) -> bytes:
    """One wire frame. Rejects objects whose JSON would embed a newline
    (impossible for json.dumps output, but the assert documents the
    framing invariant the reader relies on)."""
    line = json.dumps(msg, separators=(',', ':'))
    assert '\n' not in line
    return line.encode('utf-8') + b'\n'


def decode(line: bytes) -> Dict[str, Any]:
    msg = json.loads(line.decode('utf-8'))
    if not isinstance(msg, dict):
        raise ValueError('protocol messages must be JSON objects')
    return msg


def check_version(msg: Dict[str, Any]) -> 'Dict[str, Any] | None':
    """None when the message's protocol version is compatible, else the
    structured rejection to send back: names the offered and supported
    versions and echoes the message's ``request_id`` (when it carries
    one) so a multiplexing client can correlate the failure. A missing
    ``v`` is v1 (pre-versioning clients); a malformed one is rejected
    like an unknown major — both fail LOUDLY, never as a parse error."""
    v = msg.get('v')
    if v is None:
        return None
    try:
        major = int(str(v).split('.', 1)[0])
    except (TypeError, ValueError):
        return error(f'malformed protocol version {v!r} '
                     f'(server speaks {VERSION})',
                     code=ERR_UNSUPPORTED, v=VERSION,
                     request_id=msg.get('request_id'))
    if major != MAJOR:
        return error(f'unsupported protocol major version {v!r}; '
                     f'server speaks {VERSION}',
                     code=ERR_UNSUPPORTED, v=VERSION,
                     request_id=msg.get('request_id'))
    return None


def error(message: str, **extra: Any) -> Dict[str, Any]:
    out = {'ok': False, 'error': message}
    out.update(extra)
    return out


def ok(**fields: Any) -> Dict[str, Any]:
    out = {'ok': True}
    out.update(fields)
    return out
