"""Decode-farm worker process: decode videos, ship windows over shared
memory (the port's copy of ``video_features_tpu/farm/worker.py``).

Spawned, never forked (the parent holds a CUDA context), with a
picklable recipe (``farm/recipes.py``). A worker imports numpy, cv2 and
PIL through ``io/video.py`` and the host transforms, and never torch, so
its start costs an interpreter and cv2.

Wire protocol: every message on the worker's ``out_q`` leads with
``(kind, widx, epoch, ...)``, and the parent drops a stale epoch after a
respawn.

  ('clock', widx, epoch, t_parent0, t_worker)       clock calibration reply
  ('start', widx, epoch, seq, info)                 video opened
  ('win',   widx, epoch, seq, off, adv, shape, dtype, meta, t0, dt,
            ring_used)
  ('winq',  widx, epoch, seq, bytes, shape, dtype, meta, t0, dt)
                              queue transport of a window over half the ring
  ('end',   widx, epoch, seq, n_windows)            video drained
  ('err',   widx, epoch, seq, traceback)            video failed

Controls on ``ctrl_q``, parent to worker: ('sync', t_parent0), answered
with 'clock', so the parent can place the worker's decode spans on its
own clock; ('abort', seq) stops decoding that video (its windows are no
longer wanted); ('winq_ack',) credits back one consumed queue-transport
window (at most :data:`MAX_UNACKED_WINQ` are unacknowledged, so the
fallback is backpressured like the ring). ('stop',) on ``task_q`` ends
the process after the videos queued before it.

An exception inside one video's decode is that video's 'err', and the
worker goes on with the next. A crash takes the process; the farm fails
the video in flight, sends the queued ones to a respawned worker with a
fresh ring epoch, and unlinks the dead ring.
"""
from __future__ import annotations

import queue as queue_mod
import time
import traceback

# queue-transport windows in flight per worker: one being consumed, one
# buffered
MAX_UNACKED_WINQ = 2


class _Abort(Exception):
    """The current video's windows are no longer wanted."""


def worker_main(widx: int, epoch: int, recipe, ring_name: str,
                ring_bytes: int, task_q, out_q, free_q, ctrl_q) -> None:
    from multiprocessing import shared_memory

    import numpy as np

    from video_features_torch.farm.ring import RingProducer

    # attaching registers the segment with the shared resource tracker a
    # second time, which is harmless: the parent's unlink unregisters it
    shm = shared_memory.SharedMemory(name=ring_name)
    ring = RingProducer(shm.buf, ring_bytes)
    aborted = set()
    winq_unacked = [0]

    def on_ctrl(msg) -> None:
        if msg[0] == 'abort':
            aborted.add(msg[1])
        elif msg[0] == 'winq_ack':
            winq_unacked[0] -= 1
        elif msg[0] == 'sync':
            out_q.put(('clock', widx, epoch, msg[1], time.perf_counter()))

    def poll_ctrl() -> None:
        while True:
            try:
                on_ctrl(ctrl_q.get_nowait())
            except queue_mod.Empty:
                return

    # the parent's first 'sync' was sent at spawn; its round trip spans
    # the process start, and later re-syncs (answered in poll_ctrl while
    # decoding) tighten it
    try:
        on_ctrl(ctrl_q.get(timeout=10))
    except queue_mod.Empty:
        pass

    def wait_free_for(seq):
        def wait_free():
            poll_ctrl()
            if seq in aborted:
                raise _Abort
            try:
                ring.freed(free_q.get(timeout=0.1))
            except queue_mod.Empty:
                pass
        return wait_free

    def drain_frees() -> None:
        while True:
            try:
                ring.freed(free_q.get_nowait())
            except queue_mod.Empty:
                return

    try:
        while True:
            msg = task_q.get()
            if msg[0] == 'stop':
                break
            # ('video', seq, path, segment[, select]): segment is a
            # segment query's (start_s, end_s) range, replayed with the
            # in-process path's frame filter; select is the subset of a
            # fused recipe's families still wanting this video. Each is
            # passed only when set
            _, seq, path = msg[:3]
            kw = {}
            if len(msg) > 3 and msg[3] is not None:
                kw['segment'] = msg[3]
            if len(msg) > 4:
                kw['select'] = msg[4]
            n = 0
            try:
                info, windows = recipe.open(path, **kw)
                out_q.put(('start', widx, epoch, seq, info))
                it = iter(windows)
                wait_free = wait_free_for(seq)
                while True:
                    poll_ctrl()
                    if seq in aborted:
                        it.close()         # the recipe closes its loader
                        break
                    t0 = time.perf_counter()
                    try:
                        window, meta = next(it)
                    except StopIteration:
                        break
                    dt = time.perf_counter() - t0
                    window = np.ascontiguousarray(window)
                    if window.dtype != np.uint8:
                        # the in-process path would disagree byte for
                        # byte: fail this video, ship nothing
                        raise TypeError(
                            f'recipe produced a {window.dtype} window for '
                            f'{path}: farm windows must be uint8')
                    drain_frees()
                    region = ring.alloc(window.nbytes, wait_free)
                    if region is None:
                        while winq_unacked[0] >= MAX_UNACKED_WINQ \
                                and seq not in aborted:
                            poll_ctrl()
                            time.sleep(0.005)
                        if seq in aborted:
                            continue       # the loop's top closes it
                        winq_unacked[0] += 1
                        out_q.put(('winq', widx, epoch, seq, window.tobytes(),
                                   window.shape, window.dtype.str, meta, t0,
                                   dt))
                    else:
                        off, adv = region
                        ring.write(off, window)
                        out_q.put(('win', widx, epoch, seq, off, adv,
                                   window.shape, window.dtype.str, meta, t0,
                                   dt, ring.write_pos - ring.read_pos))
                    n += 1
                out_q.put(('end', widx, epoch, seq, n))
            except _Abort:
                out_q.put(('end', widx, epoch, seq, n))
            # vft-lint: ok=swallowed-exception — the 'err' message IS
            # the report: it carries the full traceback to the parent,
            # whose drain loop routes it through obs.events
            except Exception:
                # the per-video contract: the traceback goes to the
                # parent, which reports it; the worker stays up
                out_q.put(('err', widx, epoch, seq, traceback.format_exc()))
    finally:
        shm.close()
