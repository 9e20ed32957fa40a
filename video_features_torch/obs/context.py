"""Trace context: one ``trace_id`` across a run's spans (the port's copy
of ``video_features_tpu/obs/context.py``).

A CLI run is one trace: ``extract.base.BaseExtractor.configure_obs``
mints a root context, and each video (the per-video loop's ``video``
span, a packed :class:`~video_features_torch.parallel.packing.VideoTask`)
gets a child span under it, so one filter over ``trace_id`` finds the
whole run. Identifiers follow W3C Trace Context: a 16-byte ``trace_id``
and an 8-byte ``span_id``, lowercase hex, never all zeros. A malformed
``traceparent`` header parses to None, and :func:`accept_traceparent`
then mints.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

# version "00" traceparent: version-trace_id-parent_id-flags
_TRACEPARENT_RE = re.compile(
    r'^([0-9a-f]{2})-([0-9a-f]{32})-([0-9a-f]{16})-([0-9a-f]{2})$')


class TraceContext:
    """One (trace_id, span_id) pair; :meth:`child` derives a new span
    under the same trace."""

    __slots__ = ('trace_id', 'span_id')

    def __init__(self, trace_id: str, span_id: str) -> None:
        self.trace_id = trace_id
        self.span_id = span_id

    def child(self) -> 'TraceContext':
        return TraceContext(self.trace_id, new_span_id())

    def traceparent(self) -> str:
        """The W3C wire form, sampled flag set."""
        return f'00-{self.trace_id}-{self.span_id}-01'

    def attrs(self) -> Dict[str, str]:
        """The two span args every trace-scoped span carries."""
        return {'trace_id': self.trace_id, 'span_id': self.span_id}

    def __repr__(self) -> str:
        return f'TraceContext({self.traceparent()!r})'


def new_trace_id() -> str:
    """16 random bytes, lowercase hex; never all zeros."""
    while True:
        tid = os.urandom(16).hex()
        if tid != '0' * 32:
            return tid


def new_span_id() -> str:
    """8 random bytes, lowercase hex; never all zeros."""
    while True:
        sid = os.urandom(8).hex()
        if sid != '0' * 16:
            return sid


def mint() -> TraceContext:
    """A fresh root context."""
    return TraceContext(new_trace_id(), new_span_id())


def parse_traceparent(header: Optional[str]) -> Optional[TraceContext]:
    """The context of a W3C ``traceparent`` header, with a new span under
    the caller's; None when the header is absent, malformed or all zeros."""
    if not header or not isinstance(header, str):
        return None
    m = _TRACEPARENT_RE.match(header.strip().lower())
    if m is None:
        return None
    version, trace_id, span_id = m.group(1), m.group(2), m.group(3)
    if version == 'ff' or trace_id == '0' * 32 or span_id == '0' * 16:
        return None
    return TraceContext(trace_id, new_span_id())


def accept_traceparent(header: Optional[str]) -> TraceContext:
    """Parse, or mint when the header gives nothing."""
    return parse_traceparent(header) or mint()


def trace_attrs(task: Any) -> Dict[str, str]:
    """The span args of a task's context, or ``{}`` for a task without
    one: call sites splat it unconditionally."""
    ctx = getattr(task, 'trace', None)
    return ctx.attrs() if ctx is not None else {}


def trace_ids_of(tasks: Any) -> list:
    """The sorted distinct trace ids of some tasks: a batch span serves
    several videos and carries them all."""
    return sorted({t.trace.trace_id for t in tasks
                   if getattr(t, 'trace', None) is not None})
