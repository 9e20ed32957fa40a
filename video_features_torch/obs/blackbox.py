"""Crash-dump black box: a bounded post-mortem bundle on the way down (the
port's copy of ``video_features_tpu/obs/blackbox.py``; ``postmortem_dir``).

A trace export and a manifest are written when a run ends cleanly; the
black box dumps what the process knows when it does not, into one
directory per dump under ``postmortem_dir``:

  * ``meta.json``: reason, time, pid, the sections written, the caller's
    extras (worker, exit code, ...);
  * ``spans.json``: the recent span timeline (Chrome trace JSON, at most
    :data:`SPAN_DUMP_LIMIT` events per recorder);
  * ``events.jsonl``: the tail of the structured event log;
  * ``metrics.json`` / ``metrics.prom``: the metrics registry, when the
    owner wired it in;
  * ``manifest.json``: the run manifest so far, when there is one.

Every write is atomic and ``meta.json`` comes last, marking a complete
bundle; each section is best-effort; :meth:`BlackBox.dump` never raises;
dumps closer than :data:`MIN_DUMP_INTERVAL_S` collapse to one; and the
directory is trimmed oldest bundle first to ``postmortem_max_bytes``,
the newest always kept. The bundle format, and with it the schema name
in ``meta.json``, is the JAX package's: either package's
``validate_bundle`` reads the other's bundles.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Iterable, List, Optional

# the bundle schema, shared with the JAX package
SCHEMA = 'video_features_tpu.postmortem/1'

# per-recorder span bound for one bundle
SPAN_DUMP_LIMIT = 20_000

# the size cap of the postmortem directory when none is given (the
# config's ``postmortem_max_bytes`` default)
DEFAULT_MAX_BYTES = 64 * (1 << 20)

# two dumps closer than this collapse to one (a crash loop)
MIN_DUMP_INTERVAL_S = 2.0


class BlackBox:
    """One dump target: a directory, a byte budget, and the collectors
    that know where the telemetry lives (callables, asked at dump time)."""

    def __init__(self, postmortem_dir: str,
                 max_bytes: Optional[int] = None,
                 recorders: Optional[Callable[[], Iterable]] = None,
                 metrics_fn: Optional[Callable[[], Any]] = None,
                 prom_fn: Optional[Callable[[], str]] = None,
                 manifest_fn: Optional[Callable[[], Dict]] = None,
                 min_interval_s: float = MIN_DUMP_INTERVAL_S) -> None:
        self.postmortem_dir = str(postmortem_dir)
        self.max_bytes = int(max_bytes if max_bytes is not None
                             else DEFAULT_MAX_BYTES)
        self._recorders = recorders
        self._metrics_fn = metrics_fn
        self._prom_fn = prom_fn
        self._manifest_fn = manifest_fn
        self.min_interval_s = float(min_interval_s)
        self._lock = threading.Lock()
        self._last_dump_t = 0.0
        self._seq = 0
        self.dumps = 0                # bundles written
        self.suppressed = 0           # dumps the rate limit dropped

    # -- the one entry point -------------------------------------------------

    def dump(self, reason: str, **extra: Any) -> Optional[str]:
        """Write one bundle; returns its directory, or None when rate
        limited or when the dump failed. Never raises: it runs on crash
        paths, where a telemetry error must not hide the failure."""
        try:
            return self._dump(reason, extra)
        except Exception:
            try:
                import logging

                from video_features_torch.obs.events import event
                event(logging.ERROR, 'black-box dump failed',
                      subsystem='obs', exc_info=True, reason=reason)
            except Exception:
                pass
            return None

    def _dump(self, reason: str, extra: Dict[str, Any]) -> Optional[str]:
        now = time.monotonic()
        with self._lock:
            if now - self._last_dump_t < self.min_interval_s:
                self.suppressed += 1
                return None
            self._last_dump_t = now
            self._seq += 1
            seq = self._seq
        safe_reason = ''.join(c if c.isalnum() or c in '-_' else '_'
                              for c in str(reason))[:48] or 'unknown'
        stamp = time.strftime('%Y%m%dT%H%M%S', time.gmtime())
        bundle = os.path.join(self.postmortem_dir,
                              f'{stamp}.{seq:03d}-{safe_reason}')
        os.makedirs(bundle, exist_ok=True)

        sections: Dict[str, Any] = {}
        sections['spans'] = self._write_spans(bundle)
        sections['events'] = self._write_events(bundle)
        sections['metrics'] = self._write_metrics(bundle)
        sections['manifest'] = self._write_manifest(bundle)

        # meta last: its presence marks a complete bundle
        meta = {
            'schema': SCHEMA,
            'reason': str(reason),
            'time_unix_s': round(time.time(), 3),
            'pid': os.getpid(),
            'sections': sections,
        }
        if extra:
            from video_features_torch.obs.spans import _jsonable
            meta['extra'] = {k: _jsonable(v) for k, v in extra.items()}
        self._write_json(os.path.join(bundle, 'meta.json'), meta)
        with self._lock:
            self.dumps += 1
        self._gc()
        import logging

        from video_features_torch.obs.events import event
        event(logging.ERROR, 'black-box bundle written',
              subsystem='obs', reason=str(reason), path=bundle)
        return bundle

    # -- sections (each best-effort) -----------------------------------------

    @staticmethod
    def _write_json(path: str, doc: Any) -> None:
        from video_features_torch.utils.output import atomic_write
        atomic_write(path, lambda f: f.write(
            json.dumps(doc, sort_keys=True).encode('utf-8')))

    def _write_spans(self, bundle: str) -> bool:
        if self._recorders is None:
            return False
        try:
            from video_features_torch.obs.spans import merge_traces
            recorders = [r for r in self._recorders() if r is not None]
            if not recorders:
                return False
            doc = {
                'traceEvents': merge_traces(recorders,
                                            limit=SPAN_DUMP_LIMIT),
                'displayTimeUnit': 'ms',
                'otherData': {
                    'tool': 'video_features_torch',
                    'recorders_merged': len(recorders),
                    'events_dropped': sum(r.dropped for r in recorders),
                },
            }
            self._write_json(os.path.join(bundle, 'spans.json'), doc)
            return True
        except Exception:
            return False

    def _write_events(self, bundle: str) -> bool:
        try:
            from video_features_torch.obs.events import events_tail
            from video_features_torch.utils.output import atomic_write
            tail = events_tail()
            payload = ''.join(json.dumps(rec, sort_keys=True) + '\n'
                              for rec in tail)
            atomic_write(os.path.join(bundle, 'events.jsonl'),
                         lambda f: f.write(payload.encode('utf-8')))
            return bool(tail)
        except Exception:
            return False

    def _write_metrics(self, bundle: str) -> bool:
        wrote = False
        if self._metrics_fn is not None:
            try:
                self._write_json(os.path.join(bundle, 'metrics.json'),
                                 self._metrics_fn())
                wrote = True
            except Exception:
                pass
        if self._prom_fn is not None:
            try:
                from video_features_torch.utils.output import atomic_write
                text = self._prom_fn()
                atomic_write(os.path.join(bundle, 'metrics.prom'),
                             lambda f: f.write(text.encode('utf-8')))
                wrote = True
            except Exception:
                pass
        return wrote

    def _write_manifest(self, bundle: str) -> bool:
        if self._manifest_fn is None:
            return False
        try:
            doc = self._manifest_fn()
            if not doc:
                return False
            self._write_json(os.path.join(bundle, 'manifest.json'), doc)
            return True
        except Exception:
            return False

    # -- retention -----------------------------------------------------------

    def _gc(self) -> None:
        """Remove the oldest bundles until the directory fits
        ``max_bytes``; the newest always stays (bundle names sort by
        time: a UTC stamp and a sequence number)."""
        try:
            root = self.postmortem_dir
            bundles = sorted(
                d for d in os.listdir(root)
                if os.path.isdir(os.path.join(root, d)))
        except OSError:
            return
        sizes: Dict[str, int] = {}
        for d in bundles:
            total = 0
            for base, _, files in os.walk(os.path.join(root, d)):
                for f in files:
                    try:
                        total += os.path.getsize(os.path.join(base, f))
                    except OSError:
                        pass
            sizes[d] = total
        overall = sum(sizes.values())
        for d in bundles[:-1]:                 # the newest always survives
            if overall <= self.max_bytes:
                break
            shutil.rmtree(os.path.join(self.postmortem_dir, d),
                          ignore_errors=True)
            overall -= sizes[d]


def validate_bundle(bundle_dir: str) -> List[str]:
    """Every violation in one bundle (empty: valid): ``meta.json``
    present and well formed, and the spans section, when meta claims it,
    a valid trace-event document."""
    errors: List[str] = []
    meta_path = os.path.join(bundle_dir, 'meta.json')
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        return [f'meta.json unreadable: {e}']
    if meta.get('schema') != SCHEMA:
        errors.append(f'bad schema {meta.get("schema")!r}')
    for key in ('reason', 'time_unix_s', 'pid', 'sections'):
        if key not in meta:
            errors.append(f'meta.json missing {key!r}')
    if (meta.get('sections') or {}).get('spans'):
        try:
            with open(os.path.join(bundle_dir, 'spans.json')) as f:
                doc = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            return errors + [f'spans.json unreadable: {e}']
        events = doc.get('traceEvents')
        if not isinstance(events, list):
            errors.append('spans.json: traceEvents is not a list')
        else:
            from video_features_torch.obs.spans import validate_events
            errors += [f'spans.json: {e}' for e in validate_events(events)]
    return errors


def install_signal_dump(blackbox: BlackBox, signals=None) -> None:
    """Chain a black-box dump onto fatal signals the process can still
    catch (by default SIGQUIT and SIGABRT; a worker's SIGKILL is seen by
    the farm's supervisor instead). The handler installed before runs
    after the dump; a default action is re-raised."""
    import signal as signal_mod
    if signals is None:
        signals = tuple(
            s for s in (getattr(signal_mod, 'SIGQUIT', None),
                        getattr(signal_mod, 'SIGABRT', None))
            if s is not None)
    for sig in signals:
        prev = signal_mod.getsignal(sig)

        def _handler(signum, frame, _prev=prev):
            blackbox.dump(f'signal_{signum}')
            if callable(_prev):
                _prev(signum, frame)
            elif _prev == signal_mod.SIG_DFL:
                signal_mod.signal(signum, signal_mod.SIG_DFL)
                signal_mod.raise_signal(signum)

        try:
            signal_mod.signal(sig, _handler)
        except (OSError, ValueError):
            # not the main thread, or the platform refuses: the crash and
            # farm paths still dump
            pass
