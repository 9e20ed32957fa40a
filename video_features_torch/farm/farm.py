"""DecodeFarm: the dispatcher, the supervisor and the packed loop's window
stream over N decode worker processes (the port's copy of
``video_features_tpu/farm/farm.py``).

The farm takes the place of ``extract.streaming.
stream_windows_across_videos`` in the packed loop: it consumes the task
stream and yields the same ``(task, window, meta)`` items, with ``FLUSH``
and ``NUDGE``, but the decode runs in worker processes
(``farm/worker.py``), each shipping windows through its own bounded
shared-memory ring (``farm/ring.py``).

Threads, all in the parent:

  * the dispatcher consumes the task stream, runs the admission gate
    (the resume skip, the cache lookup) per video as it reaches it, and
    hands each video to the least-loaded worker, at most ``max(2N, 4)``
    videos ahead of the drain. With a ``cache_key_fn`` (the feature
    cache is on) a video whose content is already in flight parks
    instead of decoding a second time; once its twin is finalized it
    runs the gate again, which the twin's publish answers (a twin that
    failed leaves the parked video to decode itself);
  * the caller's thread (the packed loop's prefetch producer) runs
    :meth:`DecodeFarm.stream`'s drain loop: it waits on every worker's
    message queue, copies each window out of shared memory (freeing its
    ring space at once), keeps ``task.emitted``, ``exhausted`` and
    ``failed``, and supervises the workers: a dead worker fails only the
    video it was decoding, its queued videos go to a respawned worker
    with a fresh ring epoch, and at :data:`RESPAWN_LIMIT` respawns the
    slot stays down.

A decode error or a worker crash fails one video, as the in-process path
does; only a farm with no worker left fails the videos that remain.

A live task (an ingress live session: a task with ``windows_override``)
has no file to decode: with ``live_open`` its window source runs on a
feeder thread of the parent (its frames arrive over the network there),
whose windows the drain yields first, beside the workers'. A segment
query's range rides in the worker's task message.

The flight recorder (``obs/``): each window's ``decode`` span goes to
the tracer under its worker's own pid lane (``span_pid``), placed on the
parent's clock; the process-wide ``vft_farm_workers``,
``vft_farm_busy_workers``, ``vft_farm_ring_bytes`` gauges (summed over
the live farms, zero once every farm retired) and the
``vft_farm_respawns_total`` counter are on ``obs.metrics.REGISTRY``; a
decode error and a worker's death are warning events, and a death dumps
the ``blackbox`` given (``farm_worker_death``).
"""
from __future__ import annotations

import logging
import queue as queue_mod
import threading
import time
from collections import deque
from typing import Callable, Dict, Iterable, Iterator, List, Optional

import numpy as np

from video_features_torch.obs.context import trace_attrs
from video_features_torch.obs.events import event, log_extraction_error
from video_features_torch.obs.metrics import REGISTRY
from video_features_torch.utils.tracing import NULL_TRACER, Tracer

# respawns over a farm's life; a poison video costs at most two (one
# crash mid-decode, one on its retry)
RESPAWN_LIMIT = 8

# the round trip of a clock exchange whose midpoint is trusted: the
# offset it gives is within half of it
CLOCK_RTT_MAX_S = 0.05

_MB = 1 << 20

# the vft_farm_* gauges are process-wide and farms are per run: each write
# sums over the farms alive, so one farm's retirement does not zero a
# sibling's workers
_LIVE_FARMS: set = set()
_LIVE_LOCK = threading.Lock()
# thread-discipline declaration (vft-lint): module-level mutables and
# the lock that guards every access to them
_LOCKED_BY = {'_LIVE_FARMS': '_LIVE_LOCK'}


class FarmUnavailable(RuntimeError):
    """The farm cannot start here (no recipe, no spawn or shared memory,
    or a worker or ring that could not be created)."""


def farm_available() -> bool:
    """Whether this interpreter has shared memory and the spawn start
    method (a start can still fail, e.g. on a full ``/dev/shm``)."""
    try:
        import multiprocessing
        import multiprocessing.shared_memory  # noqa: F401
        multiprocessing.get_context('spawn')
        return True
    except (ImportError, ValueError):
        return False


class _Worker:
    __slots__ = ('idx', 'epoch', 'proc', 'shm', 'task_q', 'out_q', 'free_q',
                 'ctrl_q', 'pending', 'started', 'aborted', 'ring_used',
                 'clock_offset', 'clock_rtt', 'clock_asked')

    def __init__(self, idx: int, epoch: int) -> None:
        self.idx = idx
        self.epoch = epoch
        self.proc = None
        self.shm = None
        self.task_q = self.out_q = self.free_q = self.ctrl_q = None
        self.pending: deque = deque()   # seqs assigned, in order
        self.started: set = set()       # seqs whose 'start' arrived
        self.aborted: set = set()       # seqs sent an 'abort'
        self.ring_used = 0              # ring bytes the worker last reported
        # worker clock → parent clock, from the 'clock' reply with the
        # smallest round trip under CLOCK_RTT_MAX_S (the midpoint's error
        # is half of it); 0 until then, which is exact where perf_counter
        # is one clock for all processes (Linux). The exchange sent at
        # spawn spans the process start, so the drain re-syncs while the
        # worker decodes.
        self.clock_offset = 0.0
        self.clock_rtt = CLOCK_RTT_MAX_S
        self.clock_asked = 0.0


class DecodeFarm:
    """N decode worker processes behind one cross-video window stream.

    ``recipe`` is the family's picklable decode recipe (None: the farm
    cannot start); ``ring_bytes`` the shared-memory ring of each worker.
    With ``tracer`` enabled, each window adds the worker's decode time
    as ``decode`` (its span placed on the parent's clock) and the parent's
    copy out of the ring as ``shm_copy``, whose ``occ%`` is the ring's
    fill when the window was shipped. ``cache_key_fn(path)`` (the
    extractor's cache key) turns on duplicate parking; a path it cannot
    hash skips parking and decodes. ``blackbox`` (``obs.blackbox.
    BlackBox``) dumps a bundle when a worker dies. ``pending_cb(idx, n)``
    gets each worker's backlog on every gauge refresh (the serve
    daemon's stall watchdog), and 0 for each at shutdown.
    ``live_open(task)`` returns a live task's window iterator.
    """

    def __init__(self, recipe, workers: int = 2, ring_bytes: int = 64 * _MB,
                 tracer: Tracer = NULL_TRACER,
                 respawn_limit: int = RESPAWN_LIMIT,
                 cache_key_fn: Optional[Callable[[str], str]] = None,
                 blackbox=None,
                 pending_cb: Optional[Callable[[int, int], None]] = None,
                 live_open: Optional[Callable] = None) -> None:
        self.recipe = recipe
        self._blackbox = blackbox
        # the stall watchdog's feed (serve): ``pending_cb(worker_idx,
        # n_queued)`` mirrors each worker's assignment backlog, so one
        # wedged decode worker trips its own row while its siblings keep
        # the serve-level row advancing
        self._pending_cb = pending_cb
        self.cache_key_fn = cache_key_fn
        self.n_workers = max(int(workers), 1)
        self.ring_bytes = max(int(ring_bytes), _MB // 4)
        self.tracer = tracer
        self.respawn_limit = int(respawn_limit)
        self.ring_names: List[str] = []        # every ring this farm made
        self._lock = threading.Lock()
        self._shutdown_lock = threading.Lock()
        self._ctrl: deque = deque()            # FLUSH / NUDGE markers
        self._tasks: Dict[int, object] = {}    # seq → VideoTask
        self._next_seq = 0
        self._outstanding = 0                  # assigned, not yet ended
        self._unfinished: set = set()
        self._runahead = max(2 * self.n_workers, 4)
        self._retried: set = set()             # seqs given a retry after a crash
        self._respawns = 0
        self._inflight_keys: Dict[str, object] = {}   # cache key → its task
        self._parked: Dict[str, List] = {}            # cache key → duplicates
        self._admit = None
        self._stats = {'windows': 0, 'bytes': 0, 'queue_fallback': 0,
                       'videos_assigned': 0, 'videos_done': 0,
                       'videos_failed': 0, 'deduped': 0, 'start_s': 0.0,
                       'first_window_s': None}
        self._workers: List[_Worker] = []
        # live tasks: one feeder thread each, appending to the bounded
        # _live_out, which the drain yields before the workers' windows
        self._live_open = live_open
        self._live_out: deque = deque()
        self._live_threads: List[threading.Thread] = []
        self._dispatch_done = False
        self._dispatch_error: Optional[BaseException] = None
        self._stopping = False
        self._started = False
        self._ran = False
        self._t_start = 0.0
        self._fallback: Optional[str] = None
        self._g_workers = REGISTRY.gauge(
            'vft_farm_workers', 'decode farm worker processes alive')
        self._g_busy = REGISTRY.gauge(
            'vft_farm_busy_workers',
            'decode farm workers with videos assigned')
        self._g_ring = REGISTRY.gauge(
            'vft_farm_ring_bytes',
            'decoded bytes resident in the farm SHM rings')
        self._c_respawns = REGISTRY.counter(
            'vft_farm_respawns_total', 'decode farm worker respawns')

    # -- lifecycle -----------------------------------------------------------

    def _spawn(self, idx: int, epoch: int, requeue: Iterable[int] = ()
               ) -> _Worker:
        import multiprocessing
        from multiprocessing import shared_memory

        from video_features_torch.farm.worker import worker_main
        ctx = multiprocessing.get_context('spawn')
        w = _Worker(idx, epoch)
        w.shm = shared_memory.SharedMemory(create=True, size=self.ring_bytes)
        self.ring_names.append(w.shm.name)
        w.task_q, w.out_q = ctx.Queue(), ctx.Queue()
        w.free_q, w.ctrl_q = ctx.Queue(), ctx.Queue()
        w.proc = ctx.Process(
            target=worker_main,
            args=(idx, epoch, self.recipe, w.shm.name, self.ring_bytes,
                  w.task_q, w.out_q, w.free_q, w.ctrl_q),
            daemon=True, name=f'vft-decode-{idx}')
        try:
            w.proc.start()
        except BaseException:
            w.proc = None
            self._retire(w)
            raise
        w.ctrl_q.put(('sync', time.perf_counter()))
        for seq in requeue:
            w.pending.append(seq)
            w.task_q.put(self._task_msg(seq, self._tasks[seq]))
        return w

    @staticmethod
    def _task_msg(seq: int, task) -> tuple:
        """('video', seq, path, segment[, select]): the task's segment
        (None for a whole video), and ``task.farm_select`` (a fused
        worklist's families still wanting the video) only when set."""
        segment = getattr(task, 'segment', None)
        select = getattr(task, 'farm_select', None)
        if select is not None:
            return ('video', seq, str(task.path), segment, tuple(select))
        return ('video', seq, str(task.path), segment)

    def start(self) -> 'DecodeFarm':
        """Spawn the workers and their rings; raises
        :class:`FarmUnavailable` naming the cause, which ``stats()`` then
        keeps as ``fallback``."""
        if self._started:
            return self
        t0 = time.perf_counter()
        try:
            if self.recipe is None:
                raise FarmUnavailable('this extractor publishes no decode recipe')
            if not farm_available():
                raise FarmUnavailable(
                    'this host cannot spawn shared-memory workers')
            try:
                for i in range(self.n_workers):
                    self._workers.append(self._spawn(i, 0))
            except Exception as e:
                raise FarmUnavailable(
                    f'the decode farm failed to start ({type(e).__name__}: '
                    f'{e}; {self.n_workers} rings of {self.ring_bytes >> 20} '
                    'MiB in /dev/shm, see decode_farm_ring_mb)') from e
        except FarmUnavailable as e:
            self._fallback = str(e)
            self.shutdown()
            raise
        self._started = self._ran = True
        self._t_start = t0
        self._stats['start_s'] = time.perf_counter() - t0
        with _LIVE_LOCK:
            _LIVE_FARMS.add(self)
        self._update_gauges()
        return self

    def shutdown(self) -> None:
        """Stop the workers, reap them and unlink every ring; idempotent,
        and safe from the stream's thread and the packed loop's at once."""
        self._stopping = True
        with self._shutdown_lock:
            for w in self._workers:
                if w.task_q is not None and w.proc.is_alive():
                    w.task_q.put(('stop',))
            deadline = time.monotonic() + 5.0
            for w in self._workers:
                if w.proc is not None:
                    w.proc.join(max(0.0, deadline - time.monotonic()))
                    if w.proc.is_alive():
                        w.proc.terminate()
                        w.proc.join(1.0)
                self._retire(w)
            self._started = False
            if self._pending_cb is not None:
                # a retired farm's backlog must not read as a stall: clear
                # it first, as _update_gauges mirrors it through the hook
                for w in self._workers:
                    with self._lock:
                        w.pending.clear()
                    try:
                        self._pending_cb(w.idx, 0)
                    except Exception:
                        # vft-lint: ok=swallowed-exception — teardown: retiring the
                        # serve worker clears its rows
                        pass
        with _LIVE_LOCK:
            _LIVE_FARMS.discard(self)
        self._update_gauges()

    def _update_gauges(self) -> None:
        """The vft_farm_* gauges: workers alive, workers with videos
        assigned and ring bytes in use, over every live farm; and this
        farm's backlog per worker through ``pending_cb``."""
        with _LIVE_LOCK:
            farms = list(_LIVE_FARMS)
        workers = [w for f in farms for w in f._workers]
        self._g_workers.set(sum(1 for w in workers
                                if w.proc is not None and w.proc.is_alive()))
        self._g_busy.set(sum(1 for w in workers if w.pending))
        self._g_ring.set(sum(w.ring_used for w in workers))
        if self._pending_cb is not None:
            with self._lock:
                backlog = [(w.idx, len(w.pending)) for w in self._workers]
            for idx, n in backlog:
                try:
                    self._pending_cb(idx, n)
                except Exception:
                    # vft-lint: ok=swallowed-exception — a broken
                    # liveness hook must not take down the drain loop
                    pass

    @staticmethod
    def _retire(w: _Worker) -> None:
        """Unlink a worker's ring and close its queues, whose semaphores
        (``/dev/shm/sem.*``) go with them."""
        w.ring_used = 0
        shm, w.shm = w.shm, None
        if shm is not None:
            try:
                shm.close()
            except BufferError:
                pass    # a copy out of it still runs; the unlink stands
            shm.unlink()
        queues = (w.task_q, w.out_q, w.free_q, w.ctrl_q)
        w.task_q = w.out_q = w.free_q = w.ctrl_q = None
        for q in queues:
            if q is not None:
                q.cancel_join_thread()   # nobody reads a retired worker's queues
                q.close()

    # -- stats ---------------------------------------------------------------

    def stats(self) -> Dict[str, object]:
        """Counters over the farm's life: windows, bytes and queue
        fallbacks shipped, videos assigned, done and failed, duplicates
        parked (``deduped``), respawns,
        ring bytes in use and in all, workers alive and busy; ``ran``
        (the workers started) and ``fallback`` (why not); the seconds
        ``start()`` took (``start_s``: the spawn calls) and from its start
        to the first window (``first_window_s``: the workers' boot too)."""
        with self._lock:
            out = dict(self._stats)
            out.update(
                decode_workers=self.n_workers,
                alive_workers=sum(1 for w in self._workers
                                  if w.proc is not None and w.proc.is_alive()),
                busy_workers=sum(1 for w in self._workers if w.pending),
                ring_bytes_in_use=sum(w.ring_used for w in self._workers),
                ring_bytes_capacity=self.ring_bytes * self.n_workers,
                respawns=self._respawns, ran=self._ran,
                fallback=self._fallback)
        return out

    # -- dispatcher ----------------------------------------------------------

    def _dispatch(self, tasks: Iterable, admit) -> None:
        from video_features_torch.parallel.packing import FLUSH
        try:
            for task in tasks:
                if task is FLUSH:
                    self._append_flush()
                elif getattr(task, 'windows_override', None) is not None \
                        and self._live_open is not None:
                    # a live session: no file, its windows come from the
                    # network on a feeder thread here
                    self._start_live(task)
                elif self._gate(task, admit) and not self._park(task):
                    self._assign(task)
            # the source is spent: unpark duplicates as their twins end
            last_flush = 0.0
            while not self._stopping:
                self._resolve_parked(admit)
                with self._lock:
                    if not any(self._parked.values()):
                        break
                if time.monotonic() - last_flush > 0.05:
                    # a twin's last windows may wait in a partial pool:
                    # flush the packer so the twin can finalize
                    self._append_flush()
                    last_flush = time.monotonic()
                time.sleep(0.02)
        # vft-lint: ok=swallowed-exception — stored, not swallowed: the
        # drain loop re-raises _dispatch_error to the caller
        except BaseException as e:              # raised again by the drain
            self._dispatch_error = e
        finally:
            self._dispatch_done = True

    def _prune_live(self) -> None:
        """Drop finished feeder threads (a serve farm outlives many
        sessions)."""
        with self._lock:
            self._live_threads = [t for t in self._live_threads
                                  if t.is_alive()]

    def _start_live(self, task) -> None:
        t = threading.Thread(target=self._feed_live, args=(task,),
                             daemon=True, name='vft-farm-live')
        self._prune_live()
        with self._lock:
            self._live_threads.append(t)
        t.start()

    def _feed_live(self, task) -> None:
        """One live task's feeder: its window source's windows go to the
        drain through ``_live_out``, bounded at 64 so a stalled consumer
        holds the session back rather than growing the parent's memory;
        an arrival lull's FLUSH becomes a FLUSH marker. A failure of the
        source fails this task alone."""
        from video_features_torch.parallel.packing import FLUSH
        try:
            for item in self._live_open(task):
                if self._stopping or task.failed:
                    break
                if item is FLUSH:
                    self._append_flush()
                    continue
                window, meta = item
                task.emitted += 1
                while len(self._live_out) >= 64 and not self._stopping:
                    time.sleep(0.005)
                self._live_out.append((task, window, meta))
        except Exception:
            task.failed = True
            log_extraction_error(task.path)
        finally:
            task.exhausted = True
            if task.emitted == 0:
                self._ctrl.append(('nudge', task))
            else:
                # the session's tail windows may wait in a partial pool
                self._append_flush()

    def _append_flush(self) -> None:
        """Queue a FLUSH, held back until every video assigned before it
        has ended, as the in-process windower yields FLUSH after the
        windows of the videos before it."""
        with self._lock:
            self._ctrl.append(('flush', self._next_seq))

    def _park(self, task) -> bool:
        """With ``cache_key_fn``: True, and the task parked, when a video
        of the same content is in flight and not finalized; else the task
        becomes its key's in-flight video (False)."""
        if self.cache_key_fn is None:
            return False
        segment = getattr(task, 'segment', None)
        try:
            # a range never parks behind its whole video, nor another range
            key = (self.cache_key_fn(str(task.path), segment)
                   if segment is not None
                   else self.cache_key_fn(str(task.path)))
        except Exception:
            # vft-lint: ok=swallowed-exception — fallback by
            # design: an unhashable video skips dedupe and
            # decodes normally (its own failure reports there)
            return False              # unhashable: no parking, it decodes
        with self._lock:
            twin = self._inflight_keys.get(key)
            if twin is not None and not getattr(twin, 'finalized', False):
                self._parked.setdefault(key, []).append(task)
                self._stats['deduped'] += 1
                return True
            self._inflight_keys[key] = task
        return False

    def _resolve_parked(self, admit, block: bool = True) -> None:
        """Run the gate again for duplicates whose twin has finalized (a
        hit now, if the twin published) and assign those it lets through.
        The dispatcher calls it once the source is spent (``block``), the
        drain loop on its supervise tick (``block=False``: it never waits
        for room in the runahead window, which only it can make)."""
        with self._lock:
            ready = [key for key, twin in self._inflight_keys.items()
                     if getattr(twin, 'finalized', False)]
            # parked with no twin in flight (put back after a full window)
            ready += [key for key in self._parked
                      if key not in self._inflight_keys]
        for key in ready:
            with self._lock:
                waiters = self._parked.pop(key, [])
                self._inflight_keys.pop(key, None)
            for task in waiters:
                if not self._gate(task, admit):
                    continue
                with self._lock:
                    twin = self._inflight_keys.get(key)
                    if twin is not None and not getattr(twin, 'finalized',
                                                        False):
                        self._parked.setdefault(key, []).append(task)
                        continue
                    self._inflight_keys[key] = task
                if not self._assign(task, block=block):
                    with self._lock:
                        if self._inflight_keys.get(key) is task:
                            del self._inflight_keys[key]
                        self._parked.setdefault(key, []).append(task)

    def _gate(self, task, admit) -> bool:
        """The admission gate: False (with a NUDGE queued) for a video
        that ends without decoding: a resume skip, a cache hit, or a gate
        that raised, which fails the video as the in-process path does."""
        try:
            go = admit(task)
        except Exception:
            task.failed = True
            log_extraction_error(task.path)
            go = False
        if not go:
            task.exhausted = True
            self._ctrl.append(('nudge', task))
        return go

    def _pick_worker(self) -> Optional[_Worker]:
        """The least-loaded live worker, or None. The caller holds the lock."""
        alive = [w for w in self._workers
                 if w.proc is not None and w.proc.is_alive()]
        return min(alive, key=lambda w: len(w.pending)) if alive else None

    def _assign(self, task, block: bool = True) -> bool:
        """Hand the video to a worker, waiting while ``_runahead`` videos
        are outstanding (the drain shrinks the count); with ``block``
        False, return False instead of waiting."""
        while not self._stopping:
            with self._lock:
                if self._outstanding < self._runahead:
                    self._outstanding += 1
                    break
            if not block:
                return False
            time.sleep(0.01)
        if self._stopping:
            return True
        with self._lock:
            target = self._pick_worker()
            if target is None:
                # no worker left (the respawn budget is spent)
                task.failed = task.exhausted = True
                self._outstanding -= 1
                self._stats['videos_done'] += 1
                self._stats['videos_failed'] += 1
                self._ctrl.append(('nudge', task))
                return True
            seq = self._next_seq
            self._next_seq += 1
            self._tasks[seq] = task
            self._unfinished.add(seq)
            target.pending.append(seq)
            self._stats['videos_assigned'] += 1
        target.task_q.put(self._task_msg(seq, task))
        return True

    # -- the packed loop's stream --------------------------------------------

    def stream(self, tasks: Iterable, admit) -> Iterator:
        """Yield ``(task, window, meta)``, ``FLUSH`` and ``NUDGE`` over the
        whole task stream, as ``stream_windows_across_videos`` does with
        ``admit(task)`` run before each video's decode; shuts the farm
        down when the stream ends or is closed."""
        self.start()
        self._admit = admit
        threading.Thread(target=self._dispatch, args=(tasks, admit),
                         daemon=True, name='vft-farm-dispatch').start()
        try:
            yield from self._drain()
            if self._dispatch_error is not None:
                raise self._dispatch_error
        finally:
            self.shutdown()

    def _drain(self) -> Iterator:
        from multiprocessing.connection import wait as conn_wait

        from video_features_torch.parallel.packing import FLUSH, NUDGE
        last_supervise = 0.0
        while True:
            # live windows first: made in the parent, they must reach the
            # packer before a lull's FLUSH queued after them. Only the
            # markers counted before the windows are drained go out this
            # round: a feeder appends its window, then its FLUSH, so a
            # marker counted here has its windows in _live_out already,
            # while one appended during the drain waits a round (else it
            # overtakes its last window, which then waits in a partial
            # pool for a FLUSH that never comes)
            n_ctrl = len(self._ctrl)
            while self._live_out:
                yield self._live_out.popleft()
            while n_ctrl and self._ctrl:
                marker = self._ctrl[0]
                if marker[0] == 'flush':
                    with self._lock:
                        blocked = any(s < marker[1] for s in self._unfinished)
                    if blocked:
                        break
                    self._ctrl.popleft()
                    n_ctrl -= 1
                    yield FLUSH
                else:
                    self._ctrl.popleft()
                    n_ctrl -= 1
                    yield NUDGE
            with self._lock:
                drained = (self._dispatch_done and self._outstanding == 0
                           and not self._ctrl and not self._live_out
                           and not any(t.is_alive()
                                       for t in self._live_threads))
            if drained:
                return
            # Queue._reader (CPython's read end of the queue's pipe) is
            # the handle connection.wait multiplexes on
            readers = [w.out_q._reader for w in self._workers
                       if w.proc is not None]
            if readers:
                conn_wait(readers, timeout=0.05)
            else:
                time.sleep(0.02)
            for w in list(self._workers):
                yield from self._drain_worker(w)
            now = time.monotonic()
            if now - last_supervise >= 0.2:
                last_supervise = now
                yield from self._supervise()
                self._update_gauges()
                # a source that never ends (FLUSH between bursts) must not
                # keep a duplicate parked until it does
                self._resolve_parked(self._admit, block=False)
                self._prune_live()

    def _drain_worker(self, w: _Worker) -> Iterator:
        while w.out_q is not None:            # None: retired
            try:
                msg = w.out_q.get_nowait()
            except (queue_mod.Empty, EOFError, OSError):
                return                        # (or a worker killed mid-message)
            item = self._handle(w, msg)
            if item is not None:
                yield item

    def _handle(self, w: _Worker, msg: tuple):
        """One worker message; returns a stream item or None."""
        from video_features_torch.farm.ring import read_window
        from video_features_torch.parallel.packing import NUDGE
        kind, epoch = msg[0], msg[2]
        if epoch != w.epoch:
            return None                       # from before a respawn
        if kind == 'clock':
            t_parent0, t_worker = msg[3], msg[4]
            now = time.perf_counter()
            if now - t_parent0 < w.clock_rtt:
                w.clock_rtt = now - t_parent0
                w.clock_offset = (t_parent0 + now) / 2.0 - t_worker
            return None
        if kind == 'start':
            seq, info = msg[3], msg[4]
            w.started.add(seq)
            task = self._tasks.get(seq)
            if task is not None and info:
                task.info.update(info)
            return None
        if kind in ('win', 'winq'):
            if kind == 'win':
                seq, off, adv, shape, dtype, meta, t0, dt, used = msg[3:]
                # vft-lint: ok=stage-vocabulary — recorded divergence
                # (README, port section): the parent's copy out of the
                # ring is a stage of the port's own
                with self.tracer.stage('shm_copy'):
                    window = read_window(w.shm.buf, off, shape, dtype)
                w.free_q.put(adv)
                w.ring_used = used
                # vft-lint: ok=stage-vocabulary — the same stage's ring occupancy
                self.tracer.add_occupancy('shm_copy', used, self.ring_bytes)
            else:
                seq, payload, shape, dtype, meta, t0, dt = msg[3:]
                window = np.frombuffer(payload, np.dtype(dtype)).reshape(shape)
                w.ctrl_q.put(('winq_ack',))
                with self._lock:
                    self._stats['queue_fallback'] += 1
            with self._lock:
                self._stats['bytes'] += window.nbytes
            if w.clock_rtt >= CLOCK_RTT_MAX_S \
                    and time.monotonic() - w.clock_asked > 0.5:
                # the worker polls its controls every window, so this
                # round trip is tight
                w.clock_asked = time.monotonic()
                w.ctrl_q.put(('sync', time.perf_counter()))
            task = self._tasks.get(seq)
            if task is None:
                return None
            if task.failed:
                # the consumer failed this video: stop decoding it
                if seq not in w.aborted:
                    w.aborted.add(seq)
                    w.ctrl_q.put(('abort', seq))
                return None
            task.emitted += 1
            with self._lock:
                if not self._stats['windows']:
                    # the workers' boot (interpreter, numpy, cv2) and the
                    # first window's decode
                    self._stats['first_window_s'] = (time.perf_counter()
                                                     - self._t_start)
                self._stats['windows'] += 1
            if self.tracer.enabled:
                # the worker's own lane and its ring's fill; a fused
                # recipe's windows name the family they were decoded for
                family_of = getattr(self.recipe, 'family_of', None)
                family = family_of(meta) if family_of is not None else None
                self.tracer.add(
                    'decode', dt, t0=t0 + w.clock_offset,
                    span_pid=w.proc.pid if w.proc is not None else None,
                    span_tid=w.idx, video=str(task.path), worker=w.idx,
                    ring_used=w.ring_used, ring_capacity=self.ring_bytes,
                    **({'family': family} if family is not None else {}),
                    **trace_attrs(task))
            return task, window, meta
        if kind in ('end', 'err'):
            seq = msg[3]
            task = self._tasks.get(seq)
            self._finish_seq(w, seq)
            if task is None:
                return None
            if kind == 'err':
                task.failed = True
                event(logging.WARNING,
                      f'decode farm worker failed {task.path}:\n{msg[4]}',
                      subsystem='farm', video=str(task.path), stage='decode')
            task.exhausted = True
            with self._lock:
                self._stats['videos_done'] += 1
                self._stats['videos_failed'] += int(task.failed)
            return NUDGE if task.emitted == 0 else None
        return None

    def _finish_seq(self, w: _Worker, seq: int) -> None:
        with self._lock:
            if seq in w.pending:
                w.pending.remove(seq)
            w.started.discard(seq)
            w.aborted.discard(seq)
            self._unfinished.discard(seq)
            self._retried.discard(seq)
            self._tasks.pop(seq, None)
            self._outstanding -= 1

    def _fail_seq(self, w: _Worker, seq: int) -> Iterator:
        """End one video as failed; NUDGE when it emitted nothing."""
        from video_features_torch.parallel.packing import NUDGE
        task = self._tasks[seq]
        task.failed = task.exhausted = True
        self._finish_seq(w, seq)
        with self._lock:
            self._stats['videos_done'] += 1
            self._stats['videos_failed'] += 1
        if task.emitted == 0:
            yield NUDGE

    # -- supervision ---------------------------------------------------------

    def _supervise(self) -> Iterator:
        """Find dead workers: fail the video each was decoding, send its
        queue to a respawned worker (or, past the respawn budget, to the
        live ones)."""
        for i, w in enumerate(list(self._workers)):
            if w.proc is None or w.proc.is_alive() or self._stopping:
                continue
            yield from self._drain_worker(w)   # what it sent before dying
            with self._lock:
                pending = list(w.pending)
            victim, requeue = None, pending
            if pending:
                oldest = pending[0]
                if oldest in w.started or oldest in self._retried:
                    # it died decoding this video (or on its retry)
                    victim, requeue = oldest, pending[1:]
                else:
                    # it may never have started: one retry, so a queued
                    # video is not lost and a poison one fails the second time
                    self._retried.add(oldest)
            victim_path = (str(self._tasks[victim].path)
                           if victim is not None else None)
            with self._lock:
                respawn = self._respawns < self.respawn_limit
                self._respawns += int(respawn)
            if respawn:
                # counted before the dump, so the bundle's metrics hold it
                self._c_respawns.inc()
            event(logging.WARNING,
                  f'decode farm worker {w.idx} died '
                  f'(exitcode {w.proc.exitcode}); '
                  + (f'failing {victim_path}' if victim is not None
                     else 'no video in flight')
                  + f'; respawning with {len(requeue)} queued video(s)',
                  subsystem='farm')
            if self._blackbox is not None:
                self._blackbox.dump('farm_worker_death', worker=w.idx,
                                    exitcode=w.proc.exitcode,
                                    victim=victim_path,
                                    requeued=len(requeue))
            if victim is not None:
                yield from self._fail_seq(w, victim)
            self._retire(w)
            with self._lock:
                w.pending.clear()
                w.started.clear()
            if respawn:
                self._workers[i] = self._spawn(w.idx, w.epoch + 1, requeue)
                continue
            event(logging.WARNING,
                  f'decode farm respawn budget ({self.respawn_limit}) spent; '
                  f'worker {w.idx} stays down', subsystem='farm')
            w.proc.join(0.1)
            w.proc = None
            for seq in requeue:
                with self._lock:
                    target = self._pick_worker()
                    if target is not None:
                        target.pending.append(seq)
                if target is not None:
                    target.task_q.put(self._task_msg(seq, self._tasks[seq]))
                else:
                    yield from self._fail_seq(w, seq)


def merge_farm_stats(stats: Iterable[Dict[str, object]]) -> Dict[str, int]:
    """Sum the counters of several farms' ``stats()`` (the fused CLI's
    passes); always the full key set."""
    keys = ('decode_workers', 'alive_workers', 'busy_workers',
            'ring_bytes_in_use', 'ring_bytes_capacity', 'respawns', 'windows',
            'bytes', 'queue_fallback', 'videos_assigned', 'videos_done',
            'videos_failed', 'deduped')
    out = dict.fromkeys(keys, 0)
    for s in stats:
        for k in keys:
            out[k] += int((s or {}).get(k, 0))
    return out
