"""The packed corpus loop, batch-major across videos (port of
``video_features_tpu/parallel/packing.py``: ``VideoTask``,
``FusedTask``, ``FLUSH``, ``NUDGE``, ``packed_batches``, ``run_packed``,
``build_fused_recipe``, ``run_packed_fused``).

The per-video loop pads every video's last batch and pays the pipeline's
ramp once per video. Here:

  * a cross-video window stream (``extract.streaming.
    stream_windows_across_videos``) drains windows from one video after
    another on a producer thread (``io.video.prefetch_across_videos``),
    ``decode_ahead`` device batches of windows ahead of the card;
  * the packer (:func:`packed_batches`) fills every batch to capacity,
    one pool per window geometry, so a batch only holds windows of one
    shape; only the last batch of each geometry is padded;
  * the consumer dispatches each batch and keeps up to ``inflight`` of
    them in flight before it reads back the oldest (``sync_oldest``):
    readback, scatter and the output writes of batch k-1 overlap the
    card computing batch k;
  * rows scatter back to their videos, and a video is written as soon
    as its last window lands, through the per-video output contract
    (the resume skip, the same files, the fingerprint sidecar).

A host-side fault fails only the videos it touches: a video that does
not decode is reported and skipped, a batch whose dispatch or readback
raises fails the videos in it (``_doom``), and the worklist goes on.
A CUDA error (``extract.base.is_device_fault``) ends the run.

With ``mesh_devices`` > 1 (``extract/base.py::_ensure_packed_mesh``)
the loop plans batches at ``capacity × ndev`` (``parallel/mesh.py::
plan_device_batch``), so every device runs at its one-device batch shape,
and ``put_input`` splits each batch into one shard per device; the
in-flight queue and the scatter-back are unchanged. An uneven tail
leaves later shards partly or wholly padded, masked at scatter-back like
any padding. Occupancy is recorded per batch at the global capacity and
per device (``d<i>``) at the per-device one.

With ``decode_workers > 1`` the decode farm (``farm/``) takes the
windower's place: worker processes decode and ship the windows over
shared memory, and the loop downstream is unchanged. A fused worklist
(:func:`run_packed_fused`, ``features=[...]``) decodes each video once
for several frame-wise families and packs each family's windows apart.

The flight recorder (``obs/``): with a span recorder on the tracer,
each video gets ``video_start`` and ``video_done`` instants (with its
outcome) under a child of the run's trace context, decode spans name
their video, and ``pack``, ``model`` and ``d2h`` spans name the batch's
videos, slots and trace ids and the ``compute_dtype``; a fused run adds
one ``decode_pass`` instant per decoded video. With a run manifest,
every video's outcome, each batch geometry (``note_executable``), the
farm (``note_farm``) and the stage table (folded before the tracer's
reset) go into it. A failed batch is reported by ``log_batch_error``.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from typing import Callable, Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np
import torch

from video_features_torch.obs.context import trace_attrs, trace_ids_of
from video_features_torch.utils.output import ACTION_TO_EXT
from video_features_torch.utils.tracing import NULL_TRACER, Tracer

# Stream sentinel: "no more input for now, flush the partial pools". A
# dynamic source yields it between bursts; it passes through the
# windower and the prefetch untouched.
FLUSH = object()

# Stream marker: "a video ended without emitting a window" (resume skip,
# too short, failed open). It reaches the consumer as a batchless
# ``(None, [], 0)`` item, so the video finalizes without waiting for a
# batch.
NUDGE = object()


class VideoTask:
    """One video's scheduling and scatter-back state.

    ``emitted`` counts windows the decode side yielded, ``done`` windows
    whose rows have come back; the video is complete when ``exhausted``
    and ``done == emitted``. ``skipped`` (resume, or ``cached``: served
    from the feature cache) and ``failed`` finalize without writing;
    ``finalized`` is set once the video is written (or dropped), which
    the decode farm's duplicate parking waits for. ``rows`` and ``meta_rows`` hold the scattered rows
    in window order (a video's windows share one pool, which is FIFO);
    ``info`` holds video-level metadata (the frame-wise ``fps``).
    ``out_root`` (None: the extractor's ``output_path``) routes this
    video's files elsewhere. ``trace`` (an ``obs.context.TraceContext``,
    or None) is the video's span under the run's trace.
    """

    __slots__ = ('path', 'video_id', 'out_root', 'trace', 'rows',
                 'meta_rows', 'info', 'emitted', 'done', 'exhausted',
                 'failed', 'skipped', 'cached', 'finalized')

    def __init__(self, path: str, video_id: int = -1,
                 out_root: Optional[str] = None, trace=None) -> None:
        self.path = str(path)
        self.video_id = video_id
        self.out_root = out_root
        self.trace = trace
        self.rows: Dict[str, List[np.ndarray]] = {}
        self.meta_rows: List = []
        self.info: Dict = {}
        self.emitted = 0
        self.done = 0
        self.exhausted = False
        self.failed = False
        self.skipped = False
        self.cached = False
        self.finalized = False


class FusedTask(VideoTask):
    """One video of a fused worklist: the carrier the shared decode runs
    on, with one :class:`VideoTask` subtask per family.

    The carrier holds what the decode side touches (``emitted``,
    ``exhausted``, ``failed``, ``info``); each subtask holds its family's
    rows and outcome and is written by the family's own per-video output
    path. A family's device fault fails its subtask only; a decode fault
    fails the carrier, and with it every family still active. ``active``
    lists the families that still want the video after admission (resume
    skips drop out), and ``farm_select`` passes that subset to the decode
    (None: all of them).
    """

    __slots__ = ('subtasks', 'active', 'farm_select')

    def __init__(self, path: str, families: Iterable[str],
                 video_id: int = -1, trace=None) -> None:
        super().__init__(path, video_id=video_id, trace=trace)
        self.subtasks: Dict[str, VideoTask] = {
            fam: VideoTask(path, video_id=video_id, trace=trace)
            for fam in families}
        self.active: List[str] = list(self.subtasks)
        self.farm_select: Optional[Tuple[str, ...]] = None


def packed_batches(windows: Iterable, batch: int,
                   max_pool_age_s: Optional[float] = None,
                   tracer: Tracer = NULL_TRACER,
                   family_batch: Optional[Dict[str, int]] = None
                   ) -> Iterator[Tuple[Optional[np.ndarray], list, int]]:
    """Group a cross-video ``(task, window, meta)`` stream into full
    batches ``(stacks, provenance, valid)``, provenance being the
    ``(task, meta)`` of the ``valid`` real slots.

    Windows pool per geometry (shape and dtype), each pool holding at
    most ``batch - 1`` windows; a pool flushes when full, and the partial
    pools flush padded (the last window repeated) when the stream ends
    or a ``FLUSH`` arrives. ``FLUSH`` and ``NUDGE`` are forwarded as the
    batchless marker ``(None, [], 0)``. ``max_pool_age_s`` also flushes a
    pool whose oldest window has waited that long, when the next window
    of any geometry arrives.

    ``family_batch`` (a fused worklist: family → its batch size) keys the
    pools by the window meta's family too, ``meta = (family, t_ms)``, so
    a batch never mixes families even where their geometries match, and
    each family's pools fill and pad at its own batch size: the fused run
    steps each family's model at the shapes its solo run does.
    """
    pools: Dict[tuple, list] = {}
    ages: Dict[tuple, float] = {}

    def cap_of(key) -> int:
        return batch if family_batch is None else family_batch[key[0]]

    def flush(key):
        pool, pools[key] = pools[key], []
        ages.pop(key, None)
        cap = cap_of(key)
        # the span's provenance, built only when tracing is on (getattr:
        # tests drive the packer with plain tokens)
        attrs = {}
        if tracer.enabled:
            attrs = {'videos': sorted({str(getattr(t, 'path', t))
                                       for t, _, _ in pool}),
                     'valid': len(pool), 'capacity': cap}
            tids = trace_ids_of(t for t, _, _ in pool)
            if tids:
                attrs['trace_ids'] = tids
        with tracer.stage('pack', **attrs):
            wins = [w for _, w, _ in pool]
            wins += [wins[-1]] * (cap - len(wins))
            stacked = np.stack(wins)
        return stacked, [(t, m) for t, _, m in pool], len(pool)

    for item in windows:
        if item is FLUSH or item is NUDGE:
            if item is FLUSH:
                for key in list(pools):
                    if pools[key]:
                        yield flush(key)
            yield None, [], 0
            continue
        task, window, meta = item
        window = np.asarray(window)
        key = (window.shape, window.dtype.str)
        if family_batch is not None:
            key = (meta[0],) + key
        pool = pools.setdefault(key, [])
        if not pool:
            ages[key] = time.monotonic()
        pool.append((task, window, meta))
        if len(pool) == cap_of(key):
            yield flush(key)
        if max_pool_age_s is not None:
            now = time.monotonic()
            for k in list(pools):
                if pools[k] and now - ages[k] >= max_pool_age_s:
                    yield flush(k)
    for key in list(pools):
        if pools[key]:
            yield flush(key)


def _admit_task(ex, task: VideoTask) -> bool:
    """The per-video admission gate, run as the decode side reaches the
    video (never as an up-front scan of the worklist): False, with
    ``task.skipped`` set, when its outputs already exist, or, with
    ``task.cached`` too, when the feature cache served them. A hit drops
    out here, before batch planning: it never decodes and takes no
    batch slot."""
    if ex.is_already_exist(task.path, output_path=task.out_root):
        task.skipped = True
        return False
    if ex.cache is not None and ex.cache_fetch(task.path,
                                               output_path=task.out_root):
        task.skipped = task.cached = True
        return False
    return True


def _finalize_task(ex, task: VideoTask,
                   on_video_done: Optional[Callable] = None) -> None:
    """Write one finished video (unless skipped or failed) through the
    per-video output path and publish it to the feature cache, then free
    its rows, mark it ``finalized``, stamp its outcome on the
    extractor's span recorder (a ``video_done`` instant) and run
    manifest, and call ``on_video_done(task)``. A failed write fails the
    video; a device fault ends the run."""
    from video_features_torch.extract.base import (
        is_device_fault, log_extraction_error,
    )
    try:
        if not (task.failed or task.skipped):
            feats_dict = ex._maybe_concat_streams(ex.packed_result(task))
            with ex.tracer.stage('save', video=task.path, **trace_attrs(task)):
                ex.action_on_extraction(feats_dict, task.path,
                                        output_path=task.out_root)
            if ex.cache is not None:
                with ex.tracer.stage('cache_publish', video=task.path):
                    ex.cache_publish(task.path, output_path=task.out_root)
    except Exception as e:
        if is_device_fault(e):
            raise
        task.failed = True
        log_extraction_error(task.path, stage='save')
    finally:
        task.rows = {}
        task.finalized = True     # a parked duplicate may re-run its gate
        outcome = ('failed' if task.failed else 'cached' if task.cached
                   else 'skipped' if task.skipped
                   else 'saved' if ex.on_extraction in ACTION_TO_EXT
                   else 'printed')
        if ex.tracer.recorder is not None:
            ex.tracer.recorder.instant('video_done', video=task.path,
                                       outcome=outcome, **trace_attrs(task))
        if ex.manifest is not None:
            ex.manifest.video_done(task.path, outcome)
        if on_video_done is not None:
            on_video_done(task)


def _start_farm(ex, recipe, workers: int, cache_key_fn=None):
    """The decode farm of a packed run at ``workers`` > 1 processes,
    started; or None, with a warning naming ``decode_workers`` and the
    cause (no recipe, no spawn or shared memory, no room for the rings),
    and the run decodes in-process. ``ex._farm`` keeps the farm, whose
    ``stats()`` say whether it ran. ``cache_key_fn`` turns on the farm's
    duplicate parking."""
    from video_features_torch.farm import DecodeFarm, FarmUnavailable
    if ex.decode_backend != 'cv2':
        # build the native decoder here once, not in every worker at once
        from video_features_torch.io import native
        native.load_library()
    farm = ex._farm = DecodeFarm(recipe, workers=workers,
                                 ring_bytes=ex.decode_farm_ring_mb << 20,
                                 tracer=ex.tracer, cache_key_fn=cache_key_fn,
                                 blackbox=ex.blackbox,
                                 pending_cb=ex.watchdog_pending)
    try:
        return farm.start()
    except FarmUnavailable as e:
        warnings.warn(f'decode_workers={workers} with pack_across_videos: '
                      f'{e}; decoding in-process instead')
        return None


def _doom(prov, exc: Exception, batch: int, valid: int, stage: str,
          subtask=lambda task: task) -> None:
    """Fail the videos of a batch whose dispatch (``stage='model'``) or
    readback (``'d2h'``) raised, reported once by ``log_batch_error``
    (``subtask`` picks the task each slot's outcome lives on); their
    accounting still advances, so the sweep never stalls. A device fault
    ends the run."""
    from video_features_torch.extract.base import is_device_fault
    from video_features_torch.obs.events import log_batch_error
    if is_device_fault(exc):
        raise exc
    log_batch_error(sorted({t.path for t, _ in prov}), valid, batch,
                    stage=stage)
    for task, _ in prov:
        sub = subtask(task)
        sub.failed = True
        sub.done += 1


def _plan(ex, batch_size: Optional[int] = None) -> Tuple[int, int, int]:
    """``(ndev, capacity, batch)`` of a packed run: the extractor's packed
    mesh width, its window slots per device, and the global batch the
    packer fills (``capacity × ndev`` on a mesh)."""
    ndev = ex._ensure_packed_mesh()
    capacity = int(batch_size or ex.packed_batch_size())
    if ndev > 1:
        from video_features_torch.parallel.mesh import plan_device_batch
        return ndev, capacity, plan_device_batch(capacity, ex._mesh)
    return ndev, capacity, capacity


def _shard_valids(valid: int, capacity: int, ndev: int) -> List[int]:
    """Per-device valid slots of a ``valid``-row global batch: shard i
    holds rows ``[i·capacity, (i+1)·capacity)``."""
    return [max(0, min(valid - i * capacity, capacity)) for i in range(ndev)]


def _occupancy(ex, name: str, valid: int, plan: Tuple[int, int, int]) -> None:
    """Occupancy at the global capacity and, on a mesh, one record per
    device shard at the per-device capacity (the two never mix)."""
    ndev, capacity, batch = plan
    ex.tracer.add_occupancy(name, valid, batch)
    if ndev > 1:
        for label, v in zip(ex.mesh_labels(), _shard_valids(valid, capacity, ndev)):
            ex.tracer.add_occupancy(name, v, capacity, device=label)


def _identity(ex, dev) -> Tuple[str, tuple]:
    """A batch's executable identity (family × geometry × dtype, and the
    lane off the default) for the run manifest, with its (shape, dtype)."""
    lane = '' if ex.compute_dtype == 'float32' else f':{ex.compute_dtype}'
    dtype = dev.dtype
    name = str(dtype).replace('torch.', '')
    return (f'{ex.feature_type}:{tuple(dev.shape)}:{name}{lane}',
            (tuple(dev.shape), dtype))


def _note_run(ex, identities: Dict[str, tuple], plan: Tuple[int, int, int],
              farm) -> None:
    """After a packed run, the run manifest's ``executables`` (each batch
    geometry with its batch and ``compute_dtype``, and whatever
    ``executable_cost`` gives for it, on a meta tensor), ``mesh`` (a run
    over several devices) and ``farm``."""
    manifest = ex.manifest
    if manifest is None:
        return
    ndev, _, batch = plan
    if ndev > 1:
        manifest.note_mesh(ex.mesh_record(batch))
    for identity, (shape, dtype) in identities.items():
        info = {'batch': batch, 'compute_dtype': ex.compute_dtype}
        info.update(ex.executable_cost(
            torch.empty(shape, dtype=dtype, device='meta')) or {})
        manifest.note_executable(identity, info)
    if farm is not None:
        manifest.note_farm({'decode_workers': farm.n_workers,
                            'ring_bytes_per_worker': farm.ring_bytes,
                            'stats': farm.stats()})


def _batch_attrs(ex, prov, valid: int, plan: Tuple[int, int, int]) -> Dict:
    """The args of a batch's ``model`` and ``d2h`` spans (tracing on
    only): its videos, slots, trace ids and lane, and on a mesh its width
    and each shard's valid slots."""
    if not ex.tracer.enabled:
        return {}
    ndev, capacity, batch = plan
    attrs = {'videos': sorted({t.path for t, _ in prov}), 'valid': valid,
             'capacity': batch, 'compute_dtype': ex.compute_dtype}
    if ndev > 1:
        attrs.update(mesh_devices=ndev,
                     shard_valid=_shard_valids(valid, capacity, ndev))
    tids = trace_ids_of(t for t, _ in prov)
    if tids:
        attrs['trace_ids'] = tids
    return attrs


def _timed_windows(tracer: Tracer, source: Iterable) -> Iterator:
    """The in-process window stream with each ``next()`` timed as
    ``decode+preprocess``, the span naming the video it decoded for."""
    if not tracer.enabled:
        yield from source
        return
    it = iter(source)
    while True:
        t0 = time.perf_counter()
        try:
            item = next(it)
        except StopIteration:
            return
        attrs = {}
        if item is not FLUSH and item is not NUDGE:
            attrs = {'video': item[0].path, **trace_attrs(item[0])}
        tracer.add('decode+preprocess', time.perf_counter() - t0, t0=t0,
                   **attrs)
        yield item


def run_packed(ex, video_paths: Iterable, batch_size: Optional[int] = None,
               decode_ahead: int = 2, inflight: Optional[int] = None,
               on_video_done: Optional[Callable] = None,
               max_pool_age_s: Optional[float] = None) -> None:
    """Drive one extractor over the whole worklist, batch-major.

    ``video_paths`` yields paths or :class:`VideoTask` objects (with an
    ``out_root``), consumed lazily on the decode thread. ``batch_size``
    (default: ``ex.packed_batch_size()``) is the batch's slot count;
    ``decode_ahead`` bounds the decode lookahead at ``decode_ahead ×
    batch`` windows; ``inflight`` (default: ``ex.inflight``) is how many
    dispatched batches wait before the oldest is read back (1 =
    synchronous; the outputs are the same bytes at any depth). With
    ``ex.decode_workers > 1`` the decode farm's worker processes decode
    (``farm/``), else the producer thread does; the outputs are the
    same bytes either way.

    A dynamic source (the serve daemon's request queue) may block between
    items and yield ``FLUSH`` when idle; ``on_video_done(task)`` is called
    as each video finalizes (saved, skipped, cached or failed), and
    ``max_pool_age_s`` flushes a partial geometry pool that waited that
    long. ``ex._inflight_now`` mirrors the in-flight queue's depth.

    The per-video contracts hold: a video whose outputs exist is skipped
    with the same message; the files and their contents are those of the
    per-video loop; a video that fails to decode, compute or save is
    reported with the same message and the worklist goes on.
    """
    from video_features_torch.extract.streaming import (
        stream_windows_across_videos, transfer_batches,
    )
    from video_features_torch.io.video import prefetch_across_videos

    plan = _plan(ex, batch_size)
    ndev, capacity, batch = plan
    depth = max(int(inflight if inflight is not None else ex.inflight), 1)
    tracer = ex.tracer
    recorder = tracer.recorder
    run_ctx = ex.trace_ctx
    identities: Dict[str, tuple] = {}
    # the decode thread appends each task as the source yields it; only
    # this thread deletes (list.append and del are atomic in CPython)
    open_q: List[VideoTask] = []
    n_started = [0]

    def task_stream() -> Iterator:
        for item in video_paths:
            if item is FLUSH:
                yield FLUSH
                continue
            task = item if isinstance(item, VideoTask) else VideoTask(item)
            if task.trace is None and run_ctx is not None:
                task.trace = run_ctx.child()
            task.video_id = n_started[0]
            n_started[0] += 1
            open_q.append(task)
            if recorder is not None:
                recorder.instant('video_start', video=task.path,
                                 **trace_attrs(task))
            yield task

    def admit(task: VideoTask) -> bool:
        return _admit_task(ex, task)

    def open_windows(task: VideoTask):
        if not admit(task):
            return iter(())
        return ex.packed_windows(task)

    def sweep(final: bool = False) -> None:
        """Write every finished video. Not strictly in worklist order: a
        video whose geometry pool cannot fill yet must not hold up the
        videos behind it. The scan stops at the first video the decode
        side has not reached."""
        i = 0
        while i < len(open_q):
            t = open_q[i]
            if not t.exhausted and t.emitted == 0:
                break
            if t.exhausted and t.done >= t.emitted:
                del open_q[i]
                _finalize_task(ex, t, on_video_done)
            else:
                i += 1
        if final and open_q:
            t = open_q[0]
            raise AssertionError(
                f'packed loop lost windows for {t.path}: {t.done}/'
                f'{t.emitted} scattered, exhausted={t.exhausted}')

    # (readback, provenance, valid, span attrs), oldest first
    pending: deque = deque()

    def sync_oldest() -> None:
        readback, prov, valid, attrs = pending.popleft()
        ex._inflight_now = len(pending)
        try:
            with tracer.stage('d2h', **attrs):
                out = ex.fetch_outputs(readback)
        except Exception as e:
            _doom(prov, e, batch, valid, 'd2h')
            sweep()
            return
        _occupancy(ex, 'd2h', valid, plan)
        for i, (task, meta) in enumerate(prov):
            task.done += 1
            if task.failed:
                continue
            for key, arr in out.items():
                task.rows.setdefault(key, []).append(arr[i])
            task.meta_rows.append(meta)
        sweep()

    # with the cache on, a video whose content is already decoding parks
    # until its twin is published, and the cache then answers it
    farm = (_start_farm(ex, ex.farm_recipe(), ex.decode_workers,
                        cache_key_fn=(ex._video_cache_key
                                      if ex.cache is not None else None))
            if ex.decode_workers > 1 else None)
    if farm is None:
        windows = _timed_windows(tracer, stream_windows_across_videos(
            task_stream(), open_windows))
    else:
        windows = farm.stream(task_stream(), admit)
    ahead = prefetch_across_videos(windows, decode_ahead * batch)
    ex._inflight_now = 0
    try:
        for dev, _, prov, valid in transfer_batches(
                packed_batches(ahead, batch, max_pool_age_s=max_pool_age_s,
                               tracer=tracer),
                ex.put_input, tracer=tracer):
            if dev is None:
                # the drain marker: a video ended without a window, or the
                # source is idle; materialize the queue and finalize now
                while pending:
                    sync_oldest()
                sweep()
                continue
            attrs = _batch_attrs(ex, prov, valid, plan)
            try:
                with tracer.stage('model', **attrs), torch.inference_mode():
                    readback = ex.dispatch(dev)
            except Exception as e:
                _doom(prov, e, batch, valid, 'model')
                sweep()
                continue
            _occupancy(ex, 'model', valid, plan)
            if ex.manifest is not None:
                identity, geometry = _identity(ex, dev)
                identities.setdefault(identity, geometry)
            pending.append((readback, prov, valid, attrs))
            ex._inflight_now = len(pending)
            while len(pending) >= depth:
                sync_oldest()
        while pending:
            sync_oldest()
    finally:
        ex._inflight_now = 0
        if farm is not None:
            farm.shutdown()
    sweep(final=True)
    _note_run(ex, identities, plan, farm)
    mesh_note = f' = {capacity} x {ndev} devices' if ndev > 1 else ''
    ex.print_profile(f'packed worklist ({n_started[0]} videos, batch {batch}'
                     f'{mesh_note}) [{ex.lane_label()}]')


# -- fused worklists: one decode, several frame-wise families ----------------


def build_fused_recipe(exs: Dict):
    """The :class:`~video_features_torch.farm.recipes.FusedRecipe` of a
    family → extractor map with equal ``fused_decode_signature()``: the
    shared decode is the lead (first) family's loader, which every family
    would have built alike, branched into each family's
    ``host_transform_spec()``."""
    from video_features_torch.farm.recipes import FusedRecipe
    lead = next(iter(exs.values()))
    return FusedRecipe(
        batch_size=lead.batch_size, fps=lead.extraction_fps,
        total=lead.extraction_total, tmp_path=lead.tmp_path,
        keep_tmp=lead.keep_tmp_files, backend=lead.decode_backend,
        transforms={fam: ex.host_transform_spec() for fam, ex in exs.items()})


def run_packed_fused(exs: Dict, video_paths: Iterable, decode_ahead: int = 2,
                     inflight: Optional[int] = None) -> Dict[str, int]:
    """Drive several frame-wise extractors over one worklist with one
    decode per video; returns ``{'videos': n, 'decode_passes': m}``.

    ``exs`` maps family → extractor, all with the same
    ``fused_decode_signature()`` (else ``ValueError``). Each video's raw
    frames are decoded once and branched through every family's host
    transform (:class:`~video_features_torch.farm.recipes.FusedRecipe`),
    each window tagged ``meta = (family, t_ms)``; the packer pools per
    family and geometry at each family's own batch size, so every family
    steps its model at its solo run's shapes and writes its solo run's
    bytes.

    Each video is a :class:`FusedTask`: admission runs per (family,
    video), so resume skips and cache hits stay per family and a video
    every family skips is never decoded (``decode_passes`` counts the
    decodes). The video's content is hashed once for all its families
    (``hash_file``'s memo), so each family's cache key costs no second
    read. A
    family's device fault fails only its subtask; a decode fault fails
    the carrier, and every family with it, for that video only. With the
    lead family's ``decode_workers > 1`` the fused recipe runs in the
    decode farm (``farm/``). Each family keeps its own in-flight queue at
    its ``inflight`` depth (or ``inflight``).
    """
    from video_features_torch.extract.streaming import (
        stream_windows_across_videos,
    )
    from video_features_torch.io.video import prefetch, prefetch_across_videos

    if not exs:
        raise ValueError('run_packed_fused needs at least one family')
    sigs = {fam: ex.fused_decode_signature() for fam, ex in exs.items()}
    if None in sigs.values() or len(set(sigs.values())) != 1:
        raise ValueError('these families cannot share one decode pass; their '
                         f'fused decode signatures differ or are None: {sigs}')
    fams = list(exs)
    lead = exs[fams[0]]
    # each family keeps its own batch (and mesh) plan, so its fused batches
    # step its model at the shapes of its solo run
    plans = {fam: _plan(ex) for fam, ex in exs.items()}
    fam_batch = {fam: plan[2] for fam, plan in plans.items()}
    max_batch = max(fam_batch.values())
    depth = {fam: max(int(inflight if inflight is not None else ex.inflight), 1)
             for fam, ex in exs.items()}
    recipe = build_fused_recipe(exs)
    lead_recorder = lead.tracer.recorder
    identities: Dict[str, Dict[str, tuple]] = {fam: {} for fam in fams}
    open_q: List[FusedTask] = []
    n_started, n_decoded = [0], [0]

    def task_stream() -> Iterator:
        for item in video_paths:
            if item is FLUSH:
                yield FLUSH
                continue
            c = item if isinstance(item, FusedTask) else FusedTask(
                item, fams, trace=(lead.trace_ctx.child()
                                   if lead.trace_ctx is not None else None))
            c.video_id = n_started[0]
            n_started[0] += 1
            open_q.append(c)
            if lead_recorder is not None:
                lead_recorder.instant('video_start', video=c.path,
                                      **trace_attrs(c))
            yield c

    def admit(c: FusedTask) -> bool:
        """Per-family admission on the carrier; the families that drop
        out (resume skips, cache hits) end now and leave the decode's
        fan-out."""
        c.active = [f for f, sub in c.subtasks.items()
                    if _admit_task(exs[f], sub)]
        for f, sub in c.subtasks.items():
            if f not in c.active:
                sub.exhausted = True
        c.farm_select = (tuple(c.active) if 0 < len(c.active) < len(fams)
                         else None)
        n_decoded[0] += bool(c.active)
        if c.active and lead_recorder is not None:
            # one shared decode, whichever families it feeds
            lead_recorder.instant('decode_pass', video=c.path,
                                  families=list(c.active), **trace_attrs(c))
        return bool(c.active)

    def open_windows(c: FusedTask):
        if not admit(c):
            return iter(())
        info, windows = recipe.open(c.path, select=c.farm_select)
        c.info.update(info)
        return windows

    def counted(src):
        """Per-family ``emitted``, counted on the producer side, so it is
        final by the time the consumer sees the carrier exhausted."""
        for item in src:
            if item is not FLUSH and item is not NUDGE:
                item[0].subtasks[item[2][0]].emitted += 1
            yield item

    def to_device(item):
        stacked, prov, valid = item
        if stacked is None:
            return item
        ex = exs[prov[0][1][0]]
        with ex.tracer.stage('h2d'):
            return ex.put_input(stacked), prov, valid

    def finalize(c: FusedTask) -> None:
        for fam, sub in c.subtasks.items():
            for k, v in c.info.items():
                sub.info.setdefault(k, v)
            sub.failed = sub.failed or (c.failed and not sub.skipped)
            _finalize_task(exs[fam], sub)

    def sweep(final: bool = False) -> None:
        i = 0
        while i < len(open_q):
            c = open_q[i]
            if not c.exhausted and c.emitted == 0:
                break
            if c.exhausted and all(c.subtasks[f].done >= c.subtasks[f].emitted
                                   for f in c.active):
                del open_q[i]
                finalize(c)
            else:
                i += 1
        if final and open_q:
            c = open_q[0]
            counts = {f: (c.subtasks[f].done, c.subtasks[f].emitted)
                      for f in c.active}
            raise AssertionError(
                f'fused loop lost windows for {c.path}: (done, emitted) per '
                f'family {counts}, exhausted={c.exhausted}')

    pending = {fam: deque() for fam in fams}

    def sync_oldest(fam: str) -> None:
        ex = exs[fam]
        readback, prov, valid, attrs = pending[fam].popleft()
        try:
            with ex.tracer.stage('d2h', **attrs):
                out = ex.fetch_outputs(readback)
        except Exception as e:
            _doom(prov, e, fam_batch[fam], valid, 'd2h',
                  subtask=lambda c: c.subtasks[fam])
            sweep()
            return
        _occupancy(ex, 'd2h', valid, plans[fam])
        for i, (c, (_, t_ms)) in enumerate(prov):
            sub = c.subtasks[fam]
            sub.done += 1
            if sub.failed or c.failed:
                continue
            for key, arr in out.items():
                sub.rows.setdefault(key, []).append(arr[i])
            sub.meta_rows.append(t_ms)
        sweep()

    def drain_all() -> None:
        for fam in fams:
            while pending[fam]:
                sync_oldest(fam)

    # no duplicate parking: the families' cache keys differ, so a key of
    # the carrier could merge videos that one family still needs apart
    farm = (_start_farm(lead, recipe, lead.decode_workers)
            if lead.decode_workers > 1 else None)
    if farm is None:
        windows = _timed_windows(lead.tracer, stream_windows_across_videos(
            task_stream(), open_windows))
    else:
        windows = farm.stream(task_stream(), admit)
    ahead = prefetch_across_videos(counted(windows), decode_ahead * max_batch)
    try:
        for dev, prov, valid in prefetch(map(to_device, packed_batches(
                ahead, max_batch, tracer=lead.tracer,
                family_batch=fam_batch))):
            if dev is None:
                drain_all()
                sweep()
                continue
            fam = prov[0][1][0]
            ex = exs[fam]
            attrs = _batch_attrs(ex, prov, valid, plans[fam])
            try:
                # dispatch runs the batch in its family's precision scope:
                # adjacent batches may belong to families on other lanes
                with ex.tracer.stage('model', **attrs), torch.inference_mode():
                    readback = ex.dispatch(dev)
            except Exception as e:
                _doom(prov, e, fam_batch[fam], valid, 'model',
                      subtask=lambda c: c.subtasks[fam])
                sweep()
                continue
            _occupancy(ex, 'model', valid, plans[fam])
            if ex.manifest is not None:
                identity, geometry = _identity(ex, dev)
                identities[fam].setdefault(identity, geometry)
            pending[fam].append((readback, prov, valid, attrs))
            while len(pending[fam]) >= depth[fam]:
                sync_oldest(fam)
        drain_all()
    finally:
        if farm is not None:
            farm.shutdown()
    sweep(final=True)
    for fam, ex in exs.items():
        _note_run(ex, identities[fam], plans[fam], farm)
        ex.print_profile(f'fused worklist [{fam}] ({n_started[0]} videos, '
                         f'batch {fam_batch[fam]}) [{ex.lane_label()}]')
    return {'videos': n_started[0], 'decode_passes': n_decoded[0]}
