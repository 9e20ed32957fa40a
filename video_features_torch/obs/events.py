"""Structured event log: the error and warning channel of every loop (the
port's copy of ``video_features_tpu/obs/events.py``).

  * everything goes to **stderr**: stdout belongs to the feature stream,
    so ``on_extraction=print`` stays byte-clean;
  * every record carries its context (video path, stage, ...) as
    ``key=value`` pairs in the message and as attributes of the
    ``LogRecord`` (``record.video``);
  * a failure keeps its full traceback (``exc_info``).

Each event is also counted per (level, subsystem) (:func:`event_counts`)
and appended to a bounded tail (:func:`events_tail`), which the black
box (``obs/blackbox.py``) dumps as ``events.jsonl``.

:func:`get_logger` returns the package logger (``video_features_torch``)
with one stderr handler, attached once; it propagates, so pytest's
``caplog`` and an embedding application's logging see the records too.
"""
from __future__ import annotations

import logging
import sys
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple

LOGGER_NAME = 'video_features_torch'

_FORMAT = '%(asctime)s %(levelname)s %(name)s: %(message)s'

_configured = False
_configure_lock = threading.Lock()

# the black box's record of what the process said last
EVENT_TAIL_CAPACITY = 512

_event_lock = threading.Lock()
_event_counts: Dict[Tuple[str, str], int] = {}
_event_tail: 'deque' = deque(maxlen=EVENT_TAIL_CAPACITY)


def _record_event(level: int, msg: str, subsystem: Optional[str],
                  exc_text: Optional[str],
                  fields: Dict[str, Any]) -> None:
    levelname = logging.getLevelName(level)
    rec: Dict[str, Any] = {'t_unix_s': round(time.time(), 3),
                           'level': levelname,
                           'subsystem': subsystem or 'core',
                           'msg': msg}
    if fields:
        rec['fields'] = {k: str(v) for k, v in fields.items()}
    if exc_text:
        rec['exc'] = exc_text
    with _event_lock:
        key = (levelname, subsystem or 'core')
        _event_counts[key] = _event_counts.get(key, 0) + 1
        _event_tail.append(rec)


def event_counts() -> Dict[Tuple[str, str], int]:
    """Lifetime event counts keyed ``(level, subsystem)``."""
    with _event_lock:
        return dict(_event_counts)


def events_tail(limit: Optional[int] = None) -> List[Dict[str, Any]]:
    """The most recent structured events, newest last."""
    with _event_lock:
        tail = list(_event_tail)
    return tail[-int(limit):] if limit is not None else tail


class _StderrHandler(logging.StreamHandler):
    """A StreamHandler that looks ``sys.stderr`` up when it emits, so a
    replaced stderr (pytest's capsys) is always the one written to."""

    def __init__(self) -> None:
        super().__init__(sys.stderr)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):                   # StreamHandler.__init__ sets it
        pass


def get_logger(subsystem: Optional[str] = None) -> logging.Logger:
    """The package logger (or ``video_features_torch.<subsystem>``), its
    stderr handler installed once."""
    global _configured
    root = logging.getLogger(LOGGER_NAME)
    if not _configured:
        with _configure_lock:
            if not _configured:
                handler = _StderrHandler()
                handler.setFormatter(logging.Formatter(_FORMAT))
                root.addHandler(handler)
                if root.level == logging.NOTSET:
                    root.setLevel(logging.INFO)
                _configured = True
    return root if subsystem is None else \
        logging.getLogger(f'{LOGGER_NAME}.{subsystem}')


def event(level: int, msg: str, subsystem: Optional[str] = None,
          exc_info: bool = False, **fields: Any) -> None:
    """Log one structured event: ``msg`` plus ``key=value`` context.

    ``fields`` are appended to the message in order and set on the
    record; None-valued fields are dropped, so a call site can pass
    optional context unconditionally.
    """
    fields = {k: v for k, v in fields.items() if v is not None}
    exc_text = None
    if exc_info:
        import traceback
        exc_text = traceback.format_exc(limit=30)
    _record_event(level, msg, subsystem, exc_text, fields)
    if fields:
        ctx = ' '.join(f'{k}={v}' for k, v in fields.items())
        msg = f'{msg} [{ctx}]'
    get_logger(subsystem).log(level, msg, exc_info=exc_info, extra=fields)


def log_extraction_error(video_path, request_id: Optional[str] = None,
                         stage: Optional[str] = None) -> None:
    """The per-video failure report of every loop: a warning (the
    worklist goes on) with the full traceback, on stderr."""
    event(logging.WARNING,
          'extraction failed; continuing with the next video',
          exc_info=True, video=str(video_path), request_id=request_id,
          stage=stage)


def log_batch_error(video_paths, valid: int, batch: int,
                    stage: Optional[str] = None) -> None:
    """A packed batch failed, at its dispatch (``stage='model'``) or at
    its readback (``stage='d2h'``): the videos it carries fail and the
    worklist goes on."""
    event(logging.WARNING,
          'packed device step failed; failing only the videos in this '
          'batch and continuing',
          exc_info=True, videos=sorted(str(p) for p in video_paths),
          valid=valid, batch=batch, stage=stage)
