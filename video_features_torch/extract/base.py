"""BaseExtractor: per-video orchestration, fault isolation, idempotent
output (a slim port of ``video_features_tpu/extract/base.py``).

  * ``_extract`` = skip-if-exists → ``extract()`` → optional rgb||flow
    concat → ``action_on_extraction``; any exception is isolated per
    video (KeyboardInterrupt re-raised), reported on stderr with
    "Continuing...", so one bad file never kills the worklist;
  * ``action_on_extraction`` prints (with max/mean/min) or saves
    numpy/pickle atomically, and writes the run-fingerprint sidecar;
  * the precision lanes: ``precision`` and ``compute_dtype`` are checked
    per extractor (``config.check_lanes``), and :meth:`~BaseExtractor.
    dispatch` runs each step in :meth:`~BaseExtractor.precision_scope`,
    so extractors on different lanes in one process (a fused worklist)
    each get their own TF32 flags;
  * ``is_already_exist`` requires every output file present *and
    loadable*, and a recorded fingerprint equal to this run's
    (``cache.key.run_fingerprint``: every config key that can change the
    outputs, and the checkpoints' content);
  * the content-addressed feature cache (``cache_enabled``):
    :meth:`~BaseExtractor.configure_cache` attaches the store,
    ``_extract`` consults it before decoding (``cache_lookup``; a hit is
    the ``cached`` outcome) and publishes the saved files after
    (``cache_publish``);
  * the device loop's two ends: :meth:`~BaseExtractor.put_input` (the
    copy to the card, on the producer thread) and
    :meth:`~BaseExtractor.dispatch` / :meth:`~BaseExtractor.fetch_outputs`
    (the launch and the deferred readback, on the consumer thread), and
    :meth:`~BaseExtractor.run_batches`, the per-video loop over them;
  * the packed corpus mode (``pack_across_videos``): the hooks a family
    implements and :meth:`~BaseExtractor.extract_packed`, which runs
    ``parallel.packing.run_packed``; ``farm_recipe`` (the decode farm's
    worker-side decode) and ``fused_decode_signature`` (fused worklists);
  * the mesh (``parallel/mesh.py``): with ``data_parallel`` or
    ``mesh_devices`` > 1 the extractor holds one replica of itself per
    data shard, each with its params on its shard's device, and the
    device loop's three calls split each host batch into one shard per
    replica, launch each and concatenate their readbacks in shard order
    (:meth:`~BaseExtractor.configure_mesh`, :meth:`~BaseExtractor.
    _ensure_mesh`, :meth:`~BaseExtractor._ensure_packed_mesh`);
  * the flight recorder (``obs/``): :meth:`~BaseExtractor.configure_obs`
    attaches a span recorder to the tracer (``trace_out``), a run
    manifest (``manifest_out``) and a black box (``postmortem_dir``);
    ``_extract`` records a ``video`` span per video under the run's
    trace id, and :meth:`~BaseExtractor.finish_obs` writes the trace and
    the manifest at the end of the run.

On the card, ``put_input`` copies from pinned host memory on a copy
stream of its own and records an event; the consumer's stream waits on
that event before the step and the caching allocator is told the tensor
is used there (``record_stream``). ``dispatch`` records an event after
the step and starts the outputs' copy into pinned host memory on a
second copy stream that waits on it, so ``fetch_outputs`` waits for
that one step, never for the steps launched after it. Each object keeps
the tensors its copies read or write referenced until they are done. On
a mesh each replica keeps this discipline on its own device and streams:
a :class:`ShardedBatch` holds one ``DeviceBatch`` per shard, and
``dispatch`` gives one ``Readback`` per shard.

A CUDA error is not a per-video fault: after an illegal address or a
failed launch every later batch fails too, so :func:`is_device_fault`
errors end the run instead of "Continuing...".
"""
from __future__ import annotations

import os
import sys
import time
import warnings
from pathlib import Path
from typing import Any, Dict, Iterable, Iterator, List, Mapping, Optional, Union

import numpy as np
import torch

from video_features_torch.config import check_lanes, check_pipeline_keys
from video_features_torch.extract.streaming import (
    overlap_fetch, stream_windows, transfer_batches,
)
from video_features_torch.ops.precision import activation_dtype
from video_features_torch.utils.device import (
    gru_passes, precision_scope, resolve_device,
)
from video_features_torch.utils.output import (
    ACTION_TO_EXT, ACTION_TO_LOAD, ACTION_TO_SAVE, CorruptOutputError,
    make_path, read_fingerprint, write_fingerprint,
)
from video_features_torch.utils.tracing import NULL_TRACER, Tracer

ACTIONS = ('print',) + tuple(ACTION_TO_EXT)

def is_device_fault(e: BaseException) -> bool:
    """True for an error of the CUDA runtime, cuDNN or cuBLAS, or of a
    kernel's launch: the card's context may be lost, so the run ends
    instead of going on to the next video."""
    accelerator_error = getattr(torch, 'AcceleratorError', None)
    if accelerator_error is not None and isinstance(e, accelerator_error):
        return True
    msg = str(e)
    return isinstance(e, RuntimeError) and any(
        key in msg for key in ('CUDA', 'cuDNN', 'CUBLAS', 'failed to launch'))


def log_extraction_error(video_path, stage: Optional[str] = None) -> None:
    """The per-video fault report of every loop, through the structured
    event log (``obs/events.py``): a warning with the video's path and
    the full traceback, on stderr, so ``on_extraction=print`` keeps
    stdout clean."""
    from video_features_torch.obs.events import log_extraction_error as log
    log(video_path, stage=stage)


class DeviceBatch:
    """One input batch that ``put_input`` placed on the device. On the
    card it holds the copy's event and the pinned host tensor the copy
    reads, which stays referenced as long as the batch is."""

    __slots__ = ('tensor', 'copied', 'pinned')

    def __init__(self, tensor: torch.Tensor, copied=None, pinned=None):
        self.tensor, self.copied, self.pinned = tensor, copied, pinned

    @property
    def shape(self) -> torch.Size:
        return self.tensor.shape

    @property
    def dtype(self) -> torch.dtype:
        return self.tensor.dtype

    def take(self) -> torch.Tensor:
        """The tensor, for the consumer's current stream: that stream
        waits for the copy, and the caching allocator learns the tensor
        is used there, so its memory is not reused before the step ends."""
        if self.copied is not None:
            stream = torch.cuda.current_stream(self.tensor.device)
            stream.wait_event(self.copied)
            self.tensor.record_stream(stream)
        return self.tensor


class ShardedBatch:
    """One host batch split over a mesh's data axis: a
    :class:`DeviceBatch` per shard, each on its replica's device, and
    the host batch's ``shape``."""

    __slots__ = ('shards', 'shape')

    def __init__(self, shards: List[DeviceBatch], shape: tuple):
        self.shards, self.shape = shards, tuple(shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype


class Readback:
    """A dispatched step's outputs on their way to the host: the device
    outputs and the input batch stay referenced until ``done`` (the
    copy into ``host``) has completed."""

    __slots__ = ('out', 'host', 'done', 'inputs')

    def __init__(self, out: Dict[str, torch.Tensor], host=None, done=None,
                 inputs: Optional[DeviceBatch] = None):
        self.out, self.host, self.done, self.inputs = out, host, done, inputs


class BaseExtractor:
    """Common per-video orchestration inherited by every extractor."""

    output_feat_keys: List[str] = []

    def __init__(self, args: Mapping[str, Any]) -> None:
        """The settings every family shares, read from the run's config
        ``args`` with their defaults here."""
        on_extraction = args.get('on_extraction', 'print')
        if on_extraction not in ACTIONS:
            raise ValueError(f'on_extraction must be one of {ACTIONS}; got '
                             f'{on_extraction!r}')
        self.feature_type = args['feature_type']
        self.on_extraction = on_extraction
        self.output_path = args['output_path']
        self.device = resolve_device(args.get('device', 'cuda'))
        # the lanes: the TF32 flags and the GRU kernel's pass count of
        # ``precision`` (utils/device.py), and the stored and activation
        # dtypes of ``compute_dtype`` (ops/precision.py)
        self.precision, self.compute_dtype = check_lanes(args)
        self.gru_passes = gru_passes(self.precision)
        self.act_dtype = activation_dtype(self.compute_dtype)
        self.concat_rgb_flow = bool(args.get('concat_rgb_flow', False))
        self.tmp_path = str(args.get('tmp_path', './tmp'))
        self.keep_tmp_files = bool(args.get('keep_tmp_files', False))
        self.decode_backend = args.get('decode_backend') or 'auto'
        # the run's identity (each family sets it from its config) and
        # the feature cache, attached by configure_cache
        self.run_fingerprint = None
        self.cache = None
        # inflight: dispatched steps whose readback is deferred (1 =
        # synchronous); decode_workers: threads of the per-frame host
        # transform in the per-video loop, and the decode farm's worker
        # processes in the packed loop when > 1, each with a
        # decode_farm_ring_mb shared-memory ring
        self.inflight, self.decode_workers, self.decode_farm_ring_mb = \
            check_pipeline_keys(args)
        self._farm = None           # the last packed run's decode farm
        # profile prints the stage tables; configure_obs may enable the
        # tracer without them, for a trace or a manifest
        self.profile = bool(args.get('profile', False))
        self.tracer = Tracer() if self.profile else NULL_TRACER
        # the flight recorder, attached by configure_obs
        self.trace_ctx = None
        self.trace_out = self.manifest_out = None
        self.manifest = None
        self.blackbox = None
        # the serve daemon's stall watchdog installs
        # ``watchdog_pending(worker_idx, n_queued)``; the packed loop hands
        # it to the decode farm as its backlog feed
        self.watchdog_pending = None
        # the mesh: data_parallel's (the batch split over every local
        # device) or the packed loop's (mesh_devices, resolved by
        # configure_mesh); one replica of this extractor per data shard
        self.data_parallel = bool(args.get('data_parallel', False))
        self.mesh_devices = 1
        self._mesh = None
        self._replicas: List['BaseExtractor'] = []
        self._put_batch = None
        self._packed_mesh_ndev = 1
        if self.device.type == 'cuda':
            self._h2d_stream = torch.cuda.Stream(self.device)
            self._d2h_stream = torch.cuda.Stream(self.device)

    def precision_scope(self):
        """The TF32 flags of this extractor's ``precision``, restored on
        exit: every step of this extractor runs inside it."""
        return precision_scope(self.precision)

    def lane_label(self) -> str:
        """This extractor's lanes, for the stage tables' titles."""
        return f'precision={self.precision}, compute_dtype={self.compute_dtype}'

    # -- the device loop ----------------------------------------------------

    def put_input(self, batch: np.ndarray) -> Union[DeviceBatch, ShardedBatch]:
        """Place one host batch on the device; safe on the producer
        thread. On the card the batch is pinned and copied without
        blocking on the extractor's copy stream. On a mesh each shard goes
        to its replica's device, on that replica's copy stream."""
        if self._replicas:
            shards = self._put_batch(batch)
            return ShardedBatch([rep.put_input(rows) for rep, rows
                                 in zip(self._replicas, shards)], np.shape(batch))
        host = torch.from_numpy(np.ascontiguousarray(batch))
        if self.device.type != 'cuda':
            return DeviceBatch(host)
        pinned = host.pin_memory()
        with torch.cuda.stream(self._h2d_stream):
            tensor = pinned.to(self.device, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(self._h2d_stream)
        return DeviceBatch(tensor, copied, pinned)

    def dispatch(self, batch: Union[DeviceBatch, ShardedBatch]
                 ) -> Union[Readback, List[Readback]]:
        """Launch :meth:`packed_step` on a batch from :meth:`put_input`
        and start its outputs' readback; returns without waiting for the
        device. Call it in ``torch.inference_mode`` on the consumer
        thread. A sharded batch launches each shard on its replica (one
        ``Readback`` each)."""
        if isinstance(batch, ShardedBatch):
            return [rep.dispatch(b) for rep, b in zip(self._replicas, batch.shards)]
        if self.device.type != 'cuda':
            with self.precision_scope():
                return Readback(self.packed_step(batch.take()), inputs=batch)
        with torch.cuda.device(self.device), self.precision_scope():
            out = self.packed_step(batch.take())
        step_done = torch.cuda.Event()
        step_done.record(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self._d2h_stream):
            self._d2h_stream.wait_event(step_done)
            host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    for k, v in out.items()}
            for k, v in out.items():
                host[k].copy_(v, non_blocking=True)
            done = torch.cuda.Event()
            done.record(self._d2h_stream)
        return Readback(out, host, done, batch)

    def fetch_outputs(self, readback: Union[Readback, List[Readback]]
                      ) -> Dict[str, np.ndarray]:
        """A dispatched step's outputs as numpy arrays: waits for that
        step's readback only. An error the step raised on the device
        surfaces here. A sharded step's outputs are its shards' readbacks
        concatenated in shard order."""
        if isinstance(readback, list):
            outs = [rep.fetch_outputs(r) for rep, r in zip(self._replicas, readback)]
            return {k: np.concatenate([o[k] for o in outs]) for k in outs[0]}
        if readback.done is None:
            return {k: v.numpy() for k, v in readback.out.items()}
        readback.done.synchronize()
        return {k: v.numpy().copy() for k, v in readback.host.items()}

    def run_step(self, batch: np.ndarray) -> Dict[str, np.ndarray]:
        """One synchronous step: put, dispatch, fetch."""
        with torch.inference_mode():
            return self.fetch_outputs(self.dispatch(self.put_input(batch)))

    def run_batches(self, batches: Iterable[tuple], keep_host: bool = False,
                    depth: Optional[int] = None) -> Iterator[tuple]:
        """The per-video device loop. ``batches`` yields ``(host_batch,
        *meta)``; a producer thread runs it and copies each batch to the
        device, this thread dispatches each step, and the outputs come
        back as ``(outputs, host_batch | None, *meta)``, in order,
        ``depth`` dispatches later (default ``inflight``). A ``None``
        batch comes back as ``None`` outputs, its meta in its place."""
        def dispatched():
            for dev, host, *meta in transfer_batches(
                    batches, self.put_input, keep_host=keep_host,
                    tracer=self.tracer):
                readback = None
                if dev is not None:
                    with self.tracer.stage('model'), torch.inference_mode():
                        readback = self.dispatch(dev)
                yield (readback, host, *meta)

        def fetch(readback):
            return None if readback is None else self.fetch_outputs(readback)

        return overlap_fetch(dispatched(), fetch,
                             self.inflight if depth is None else depth,
                             self.tracer)

    # -- the mesh (parallel/mesh.py) ----------------------------------------

    # what a replica holds on its own device: its params, and any other
    # tensor or module its step reads (vggish: the module and the PCA)
    _device_state_attrs: tuple = ('params',)

    def _device_state(self) -> Dict[str, Any]:
        return {a: getattr(self, a) for a in self._device_state_attrs
                if getattr(self, a, None) is not None}

    def params_nbytes(self) -> int:
        """The bytes of this extractor's device state (its params, and
        whatever else ``_device_state_attrs`` names), one copy: what the
        serve daemon's placer (``serve/pool.py::DevicePlacer``) charges
        each device it puts this extractor on."""
        def nbytes(value) -> int:
            if isinstance(value, torch.Tensor):
                return value.numel() * value.element_size()
            if isinstance(value, torch.nn.Module):
                return sum(nbytes(t) for t in value.state_dict().values())
            if isinstance(value, dict):
                return sum(nbytes(v) for v in value.values())
            if isinstance(value, (list, tuple)):
                return sum(nbytes(v) for v in value)
            return sum(nbytes(v) for v in getattr(value, '__dict__', {}).values())
        return nbytes(self._device_state())

    def place_on(self, devices: List[torch.device]) -> None:
        """Pin this extractor to ``devices`` before its first batch (the
        serve daemon's placement): one device moves the device state
        there, with copy streams of its own; several are the devices the
        packed loop's mesh (``mesh_devices``) is built over."""
        from video_features_torch.parallel.mesh import move
        devices = [torch.device(d) for d in devices]
        if not devices:
            return
        self._placement_devices = devices
        if self._mesh is not None or len(devices) > 1:
            return
        dev = devices[0]
        here = self.device
        if here.type == 'cuda' and here.index is None:
            here = torch.device('cuda', torch.cuda.current_device())
        if dev == here:
            return
        for attr, value in self._device_state().items():
            setattr(self, attr, move(value, dev))
        self.device = dev
        if dev.type == 'cuda':
            self._h2d_stream = torch.cuda.Stream(dev)
            self._d2h_stream = torch.cuda.Stream(dev)

    def _install_mesh(self, mesh, states: List[Dict[str, Any]],
                      put_batch) -> None:
        """One replica per data shard of ``mesh``: a shallow copy of this
        extractor on the shard's device, with ``states[i]`` (its device
        state there) and copy streams of its own; ``put_batch`` splits a
        host batch into the shards."""
        import copy
        replicas = []
        for dev, state in zip(mesh.data_devices(), states):
            rep = copy.copy(self)
            rep.device = torch.device(dev)
            rep._mesh, rep._replicas = None, []
            for attr, value in state.items():
                setattr(rep, attr, value)
            if rep.device.type == 'cuda':
                rep._h2d_stream = torch.cuda.Stream(rep.device)
                rep._d2h_stream = torch.cuda.Stream(rep.device)
            replicas.append(rep)
        self._mesh, self._replicas, self._put_batch = mesh, replicas, put_batch

    def _ensure_mesh(self, batch_attr: str) -> None:
        """``data_parallel``: a data mesh over every local device of this
        extractor's kind, the batch attribute named ``batch_attr`` rounded
        up to the global batch, one replica per device
        (``parallel/pipeline.py::setup_data_parallel``). Families call it
        once their device state is loaded."""
        if self._mesh is not None:
            return
        from video_features_torch.parallel.pipeline import setup_data_parallel
        mesh, global_batch, states, split = setup_data_parallel(
            self.device, getattr(self, batch_attr), self._device_state())
        self._install_mesh(mesh, states, split)
        setattr(self, batch_attr, global_batch)

    def configure_mesh(self, args: Mapping[str, Any]) -> None:
        """Resolve the ``mesh_devices`` knob against this process's local
        devices (``utils/device.py::local_devices``): ``0`` is every local
        device, an over-ask raises naming the counts. Called by
        ``registry.create_extractor``; an extractor constructed directly
        stays on one device."""
        n = args.get('mesh_devices', 1)
        n = 1 if n is None else int(n)
        if n != 1:
            from video_features_torch.utils.device import local_devices
            local = local_devices(self.device)
            if n == 0:
                n = len(local)
            elif n > len(local):
                raise ValueError(
                    f'mesh_devices={n} but this host has only '
                    f'{len(local)} local {local[0].type} device(s) — '
                    'lower mesh_devices (or 0 to auto-detect)')
        self.mesh_devices = max(n, 1)

    def use_mesh(self, mesh) -> None:
        """Run the packed loop over ``mesh``, a data mesh the caller built
        (``make_mesh(devices=...)``, where a device may appear twice): one
        replica per shard, batches planned at ``capacity × ndev``."""
        from functools import partial

        from video_features_torch.parallel.mesh import replicate, split_batch
        self._install_mesh(mesh, replicate(self._device_state(), mesh),
                           partial(split_batch, mesh=mesh))
        self.mesh_devices = self._packed_mesh_ndev = mesh.shape['data']

    def _ensure_packed_mesh(self) -> int:
        """The packed loop's data mesh when ``mesh_devices > 1``: the
        first ``mesh_devices`` local devices, one replica each. Returns
        the data-axis size (1: one device). Idempotent; an extractor that
        already owns a mesh (``data_parallel``, with its batch already the
        global one; ``sequence_parallel``) keeps it and its batch plan."""
        if self._mesh is not None:
            return self._packed_mesh_ndev
        n = int(self.mesh_devices or 1)
        if n <= 1:
            return 1
        from video_features_torch.parallel.mesh import make_mesh
        from video_features_torch.utils.device import local_devices
        devices = (getattr(self, '_placement_devices', None)
                   or local_devices(self.device))
        self.use_mesh(make_mesh(n_devices=n, time_parallel=1, devices=devices))
        return n

    def mesh_record(self, batch: int) -> Dict[str, Any]:
        """The run manifest's ``mesh`` section for ``batch``-row global
        batches over this extractor's mesh (``obs/manifest.py::
        note_mesh``)."""
        n = len(self._replicas)
        return {'mesh_devices': n, 'shape': dict(self._mesh.shape),
                'devices': self.mesh_labels(),
                'capacity_per_device': batch // n, 'global_batch': batch,
                'compute_dtype': self.compute_dtype}

    def mesh_labels(self) -> List[str]:
        """Per-shard labels ``d<i>``, in shard order."""
        return [f'd{i}' for i in range(len(self._replicas))]

    def print_profile(self, title: str) -> None:
        """End of a video or a packed run: fold the stage table into the
        run manifest, print it on stderr with ``profile``, then reset."""
        if not self.tracer.enabled:
            return
        report = self.tracer.report()
        if not report:
            return
        if self.manifest is not None:
            self.manifest.fold_stages(report)
        if self.profile:
            print(f'--- stage timing: {title}', file=sys.stderr)
            print(self.tracer.summary(), file=sys.stderr)
        self.tracer.reset()

    def video_loader(self, video_path: str, **kwargs):
        """A :class:`~video_features_torch.io.video.VideoLoader` that
        decodes with this run's ``decode_backend`` and re-encodes into its
        ``tmp_path`` (kept with ``keep_tmp_files``); use it as a context
        manager."""
        from video_features_torch.io.video import VideoLoader
        return VideoLoader(video_path, tmp_path=self.tmp_path,
                           keep_tmp=self.keep_tmp_files,
                           backend=self.decode_backend, **kwargs)

    # -- content-addressed feature cache (cache/) ---------------------------

    def configure_cache(self, args: Mapping[str, Any]) -> None:
        """With ``cache_enabled`` (and outputs saved to disk), attach the
        process-wide store of ``cache_dir`` (with ``cache_l2_dir``, the
        two-level tier). ``registry.create_extractor`` calls it with the
        merged config; a store that cannot open is reported and the run
        goes on uncached."""
        if not args.get('cache_enabled') or self.on_extraction not in ACTION_TO_EXT:
            return
        from video_features_torch.cache import FeatureCache, log_cache_error
        try:
            l2 = args.get('cache_l2_dir')
            if l2:
                from video_features_torch.fleet.tier import TieredFeatureCache
                self.cache = TieredFeatureCache.get_pair(
                    args['cache_dir'], l2, args.get('cache_max_bytes'))
            else:
                self.cache = FeatureCache.get(args['cache_dir'],
                                              args.get('cache_max_bytes'))
        except Exception:
            log_cache_error(f'open ({args.get("cache_dir")})')
            self.cache = None

    def _video_cache_key(self, video_path: str) -> str:
        from video_features_torch.cache.key import video_cache_key
        return video_cache_key(video_path, self.run_fingerprint)

    def cache_fetch(self, video_path: str, output_path: Optional[str] = None
                    ) -> bool:
        """Serve this video's outputs from the cache: a hit writes the
        stored files (and the resume sidecar) under the output root with
        no decode and no step. A cache failure is a miss, never a failed
        video."""
        if self.cache is None or self.run_fingerprint is None:
            return False
        from video_features_torch.cache import log_cache_error
        out_root = output_path or self.output_path
        try:
            hit = self.cache.fetch_to(self._video_cache_key(video_path),
                                      out_root, video_path,
                                      fingerprint=self.run_fingerprint)
        except Exception:
            log_cache_error(f'lookup for {video_path}')
            return False
        if hit:
            print(f'Features for {video_path} served from cache into '
                  f'{Path(out_root).absolute()}/ - skipping extraction..')
        return hit

    def cache_publish(self, video_path: str, output_path: Optional[str] = None
                      ) -> None:
        """Publish the files just saved for this video (their exact
        bytes, so every later hit is byte-identical to this run)."""
        if self.cache is None or self.run_fingerprint is None:
            return
        from video_features_torch.cache import hash_file, log_cache_error
        out_root = output_path or self.output_path
        ext = ACTION_TO_EXT[self.on_extraction]
        files = {key: (make_path(out_root, video_path, key, ext), ext)
                 for key in self._saved_feat_keys()}
        if not all(os.path.exists(src) for src, _ in files.values()):
            return                       # a partial save: nothing to publish
        try:
            self.cache.put(self._video_cache_key(video_path), files,
                           meta={'video': Path(video_path).name,
                                 'feature_type': self.feature_type,
                                 'video_sha256': hash_file(video_path)})
        except Exception:
            log_cache_error(f'publish for {video_path}')

    # -- the flight recorder (obs/) -----------------------------------------

    def configure_obs(self, args: Mapping[str, Any]) -> None:
        """Attach the flight recorder the config asks for:
        ``postmortem_dir`` a black box (dumped on a fatal signal by the
        CLI and on a decode worker's death by the farm, with the spans,
        the event tail, the metrics registry and the manifest so far);
        ``trace_out`` a span recorder of ``trace_capacity`` events on the
        tracer; ``manifest_out`` a run manifest. Either of the last two
        mints the run's trace context and enables the tracer (the tables
        stay gated on ``profile``). ``registry.create_extractor`` calls
        it; an extractor constructed directly records nothing."""
        trace_out = args.get('trace_out')
        manifest_out = args.get('manifest_out')
        if args.get('postmortem_dir'):
            from video_features_torch.obs.blackbox import BlackBox
            from video_features_torch.obs.metrics import REGISTRY
            self.blackbox = BlackBox(
                str(args['postmortem_dir']),
                max_bytes=args.get('postmortem_max_bytes'),
                recorders=lambda: [self.tracer.recorder],
                metrics_fn=REGISTRY.collect, prom_fn=REGISTRY.render,
                manifest_fn=lambda: (self.manifest.document()
                                     if self.manifest is not None else None))
        if not (trace_out or manifest_out):
            return
        # a CLI run is one trace: every video is a child span under it
        from video_features_torch.obs.context import mint
        self.trace_ctx = mint()
        if not self.tracer.enabled:
            self.tracer = Tracer()
        if trace_out:
            from video_features_torch.obs.spans import (
                DEFAULT_CAPACITY, SpanRecorder,
            )
            self.trace_out = str(trace_out)
            self.tracer.recorder = SpanRecorder(
                int(args.get('trace_capacity') or DEFAULT_CAPACITY))
        if manifest_out:
            from video_features_torch.obs.manifest import RunManifest
            self.manifest_out = str(manifest_out)
            self.manifest = RunManifest(args)
            if self._replicas:              # data_parallel's mesh
                self.manifest.note_mesh(self.mesh_record(int(self.batch_size)))

    def finish_obs(self, export_trace: bool = True) -> None:
        """Write the run's manifest and trace (the CLI's end of run, in a
        ``finally``; a serve worker's end, which passes
        ``export_trace=False`` where the daemon writes one merged trace to
        the same path). Never raises: a failed write is a warning event,
        and the run's outputs, already saved, stand."""
        import logging

        from video_features_torch.obs.events import event
        if self.manifest is not None and self.manifest_out:
            try:
                # what was recorded since the loops' last fold
                self.manifest.fold_stages(self.tracer.report())
                self.manifest.write(self.manifest_out)
            except Exception:
                event(logging.WARNING, 'run-manifest write failed',
                      exc_info=True, path=self.manifest_out)
        if export_trace and self.tracer.recorder is not None and self.trace_out:
            try:
                self.tracer.recorder.export(self.trace_out)
            except Exception:
                event(logging.WARNING, 'trace export failed',
                      exc_info=True, path=self.trace_out)

    def executable_cost(self, batch) -> None:
        """The JAX package's XLA cost analysis of the step at ``batch``'s
        geometry has no counterpart in eager PyTorch: None, so the run
        manifest's ``executables`` records carry no FLOPs or bytes."""
        return None

    def _extract(self, video_path: str) -> str:
        """Fault-isolating wrapper around :meth:`extract` for the work
        loop; returns the video's outcome (``skipped``, ``cached``,
        ``saved``, ``printed`` or ``failed``), which the run manifest and
        the ``video`` span record. A device fault
        (:func:`is_device_fault`) ends the run."""
        recorder = self.tracer.recorder
        t0_video = time.perf_counter()
        video_ctx = self.trace_ctx.child() if self.trace_ctx is not None else None
        outcome = 'failed'
        try:
            if self.is_already_exist(video_path):
                outcome = 'skipped'
                return outcome
            if self.cache is not None:
                with self.tracer.stage('cache_lookup', video=str(video_path)):
                    hit = self.cache_fetch(video_path)
                if hit:
                    outcome = 'cached'
                    return outcome
            feats_dict = self._maybe_concat_streams(self.extract(video_path))
            with self.tracer.stage('save', video=str(video_path)):
                self.action_on_extraction(feats_dict, video_path)
            if self.cache is not None:
                with self.tracer.stage('cache_publish', video=str(video_path)):
                    self.cache_publish(video_path)
            outcome = 'saved' if self.on_extraction in ACTION_TO_EXT else 'printed'
        except Exception as e:
            if is_device_fault(e):
                raise
            log_extraction_error(video_path)
        finally:
            # the video's stages fold into the manifest before the reset
            self.print_profile(str(video_path))
            if self.manifest is not None:
                self.manifest.video_done(video_path, outcome)
            if recorder is not None:
                recorder.span('video', t0_video, time.perf_counter(),
                              video=str(video_path), outcome=outcome,
                              **(video_ctx.attrs() if video_ctx is not None
                                 else {}))
        return outcome

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    # -- packed corpus mode (pack_across_videos=true) -----------------------
    #
    # parallel.packing.run_packed fills every device batch across video
    # boundaries and scatters the rows back per video. A family opts in
    # with ``supports_packing = True`` and the hooks below.

    supports_packing = False

    def packed_batch_size(self) -> int:
        """Window slots per packed device batch."""
        return int(self.batch_size)

    def packed_windows(self, task):
        """Yield ``(window, meta)`` for one video in window order: the
        host array one batch slot carries, and per-window metadata
        scattered back beside the features (or None). Video-level
        metadata goes in ``task.info``."""
        raise NotImplementedError

    def packed_step(self, batch: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One step on a ``(B, ...)`` device batch → ``{key: (B, D)}``
        device tensors; launches and returns without waiting."""
        raise NotImplementedError

    def packed_result(self, task) -> Dict[str, np.ndarray]:
        """One video's feats_dict from its scattered rows (``task.rows``,
        ``task.meta_rows``, ``task.info``): what :meth:`extract` returns
        for it."""
        raise NotImplementedError

    def farm_recipe(self):
        """The picklable recipe (``farm/recipes.py``) that replays this
        family's decode and host transform in a decode farm worker, byte
        for byte, or None: the packed loop then decodes in-process, with
        a warning."""
        return None

    # the source geometry the serve daemon's prewarm step runs at: the
    # JAX package's canonical decode geometry (``PROGRAM_DECODE_HW``), at
    # which its prewarm loads executables. The geometry-free warm-up (the
    # kernels' builds, the CUDA context, the cuBLAS and cuDNN handles)
    # holds for every request; a first batch of another geometry still
    # pays its own cuDNN plans and allocations
    WARM_FRAME_HW = (240, 320)

    def warm_window(self) -> Optional[np.ndarray]:
        """One zero window of this family's packed geometry from a
        :data:`WARM_FRAME_HW` source, which the serve daemon's prewarm
        steps once; None: the family is built but not stepped."""
        return None

    def fused_decode_signature(self):
        """Families whose signatures are equal, and not None, decode one
        raw frame stream per video in a fused worklist
        (``parallel.packing.run_packed_fused``): the signature covers
        everything before the per-frame host transform. None keeps the
        family out of any fused group."""
        return None

    def extract_packed(self, video_paths: Iterable, decode_ahead: int = 2,
                       batch_size: Optional[int] = None,
                       inflight: Optional[int] = None,
                       on_video_done=None,
                       max_pool_age_s: Optional[float] = None) -> None:
        """Run the whole worklist batch-major (``parallel.packing``):
        ``video_paths`` yields paths, ``VideoTask`` objects or ``FLUSH``,
        lazily and possibly blocking (the serve daemon feeds its request
        queue through here); ``inflight`` overrides the extractor's
        readback depth; ``on_video_done(task)`` is called as each video
        finalizes; ``max_pool_age_s`` bounds how long a partial batch
        waits for batch-mates. With ``decode_workers > 1`` the decode
        farm's worker processes decode."""
        if not self.supports_packing:
            raise NotImplementedError(
                f'{type(self).__name__} does not support pack_across_videos')
        from video_features_torch.parallel.packing import run_packed
        run_packed(self, video_paths, batch_size=batch_size,
                   decode_ahead=decode_ahead, inflight=inflight,
                   on_video_done=on_video_done, max_pool_age_s=max_pool_age_s)

    def _maybe_concat_streams(self, feats_dict: Dict[str, np.ndarray]
                              ) -> Dict[str, np.ndarray]:
        """rgb||flow → one (T, 2C) array under 'rgb' when configured."""
        if self.concat_rgb_flow and 'rgb' in feats_dict and 'flow' in feats_dict:
            feats_dict = dict(feats_dict)
            flow = feats_dict.pop('flow')
            feats_dict['rgb'] = np.concatenate((feats_dict['rgb'], flow), axis=1)
        return feats_dict

    def action_on_extraction(self, feats_dict: Dict[str, np.ndarray],
                             video_path: str,
                             output_path: Optional[str] = None) -> None:
        """Print or save one video's features; ``output_path`` (default:
        the run's) routes this video's files elsewhere."""
        out_root = output_path or self.output_path
        if self.on_extraction in ACTION_TO_EXT and \
                self.is_already_exist(video_path, output_path=out_root):
            # a concurrent worker finished this video while we extracted it
            warnings.warn('extraction didnt find feature files on the 1st '
                          f'try but did on the 2nd try: {video_path}')
            return
        for key, value in feats_dict.items():
            if self.on_extraction == 'print':
                print(key)
                print(value)
                print(f'max: {value.max():.8f}; mean: {value.mean():.8f}; '
                      f'min: {value.min():.8f}')
                print()
                continue
            os.makedirs(out_root, exist_ok=True)
            fpath = make_path(out_root, video_path, key,
                              ACTION_TO_EXT[self.on_extraction])
            if np.ndim(value) and len(value) == 0:    # 'fps' is 0-d
                warnings.warn(f'the value is empty for {key} @ {fpath}')
            ACTION_TO_SAVE[self.on_extraction](fpath, value)
        if self.on_extraction in ACTION_TO_EXT \
                and self.run_fingerprint is not None:
            write_fingerprint(out_root, video_path, self.run_fingerprint)

    def is_already_exist(self, video_path: Union[str, Path],
                         output_path: Optional[str] = None) -> bool:
        """True iff every output file under ``output_path`` (default: the
        run's) exists and loads cleanly, and no sidecar says a different
        config produced them."""
        if self.on_extraction not in ACTION_TO_EXT:
            return False
        out_root = output_path or self.output_path
        for key in self._saved_feat_keys():
            fpath = make_path(out_root, video_path, key,
                              ACTION_TO_EXT[self.on_extraction])
            if not Path(fpath).exists():
                return False
            try:
                ACTION_TO_LOAD[self.on_extraction](fpath)
            except CorruptOutputError as e:
                warnings.warn(f'existing output failed to load; '
                              f're-extracting ({e})')
                return False
        recorded = read_fingerprint(out_root, video_path)
        if recorded is not None and self.run_fingerprint is not None \
                and recorded != self.run_fingerprint:
            warnings.warn(f'Existing outputs for {video_path} were produced '
                          'under a different config/checkpoint — '
                          're-extracting instead of reusing them')
            return False
        print(f'Features for {video_path} already exist in '
              f'{Path(out_root).absolute()}/ - skipping..')
        return True

    def _saved_feat_keys(self) -> List[str]:
        """Keys that reach disk: the concat folds 'flow' into 'rgb'."""
        keys = list(self.output_feat_keys)
        if self.concat_rgb_flow and 'rgb' in keys and 'flow' in keys:
            keys.remove('flow')
        return keys


class StackPackingMixin:
    """The packed hooks of the stack families that window raw decoded
    frames (r21d, s3d): one window is a ``(stack_size, H, W, 3)`` frame
    stack; the class sets ``packed_feat_dim`` and provides
    ``packed_step``."""

    supports_packing = True
    packed_feat_dim = 0

    def packed_windows(self, task):
        with self.video_loader(task.path, batch_size=64,
                               fps=self.extraction_fps) as loader:
            for window in stream_windows(loader, self.stack_size,
                                         self.step_size):
                yield window, None

    def packed_result(self, task) -> Dict[str, np.ndarray]:
        rows = task.rows.get(self.feature_type, [])
        return {self.feature_type: (
            np.stack(rows) if rows
            else np.zeros((0, self.packed_feat_dim), np.float32))}

    def warm_window(self) -> np.ndarray:
        return np.zeros((self.stack_size, *self.WARM_FRAME_HW, 3), np.uint8)

    def farm_recipe(self):
        """Raw frame stacks: the window geometry and the loader's knobs."""
        from video_features_torch.farm.recipes import StackRecipe
        return StackRecipe(
            win=self.stack_size, step=self.step_size, batch_size=64,
            fps=self.extraction_fps, total=None, tmp_path=self.tmp_path,
            keep_tmp=self.keep_tmp_files, backend=self.decode_backend,
            transform=None)
