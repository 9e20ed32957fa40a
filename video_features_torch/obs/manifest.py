"""Per-run JSON run manifest: what ran, on what, and what it cost (the
port's copy of ``video_features_tpu/obs/manifest.py``; ``manifest_out=``).

One document with the JAX package's key set:

  * the merged **config** and the config, weights and run
    **fingerprints** (``cache/key.py``: the identities the feature cache
    and resume key on);
  * the run-wide **stage** table (each ``Tracer.report`` folded in with
    ``merge_reports``);
  * per-**video outcomes** (saved, skipped, cached, failed, printed) and
    their counts;
  * **compile**: the ``nvcc`` builds of the CUDA kernels this process
    ran during the run (``ops/_kernels.py::build_record``), as
    ``{'nvcc:<kernel>': {'count', 'total_s'}}``; a library that was
    already built is loaded, not compiled, and records nothing;
  * **executables**: one record per executable identity (family × input
    geometry × dtype) with its batch and ``compute_dtype``; eager
    PyTorch has no ahead-of-time cost analysis, so no FLOPs or bytes;
  * **farm**: the decode farm's configuration and lifetime stats;
  * **mesh**: a packed run over several devices (``mesh_devices``): its
    width, (data, time) shape, device labels, per-device capacity, global
    batch and lane; ``{}`` on one device;
  * **index**: the feature index's view (``note_index``, from the
    offline ``index`` CLI): rows, shards, ingest counters; ``{}``
    otherwise;
  * **aot**: the executable store's view (``note_aot``, from
    ``BaseExtractor.aot_snapshot``): how many kernel libraries were
    loaded from the store and how many compiled, and per library its
    path and identity; ``{}`` without ``aot_enabled``;
  * ``ingress``, ``programs_lock`` and ``slo`` stay ``{}``: the port
    writes none of those sections yet.

The loops push (``video_done``, ``fold_stages``, ``note_executable``,
``note_farm``, ``note_mesh``, ``note_index``, ``note_aot``);
:meth:`RunManifest.write` publishes atomically.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, Mapping, Optional

from video_features_torch.obs.spans import _jsonable
from video_features_torch.utils.tracing import merge_reports

SCHEMA = 'video_features_torch.run_manifest/1'


def _compile_snapshot() -> Dict[str, Dict[str, float]]:
    """The process's kernel builds so far, keyed ``nvcc:<kernel>``."""
    from video_features_torch.ops._kernels import build_record
    return {f'nvcc:{name}': rec for name, rec in build_record().items()}


class RunManifest:
    """Accumulates one run's outcomes, stages and executables; writes
    atomic JSON."""

    def __init__(self, args: Mapping[str, Any]) -> None:
        self._lock = threading.Lock()
        self._t0 = time.time()
        self._t0_perf = time.perf_counter()
        self.config: Dict[str, Any] = {k: _jsonable(v)
                                       for k, v in dict(args).items()}
        self.fingerprints = self._fingerprints(args)
        self.videos: Dict[str, Dict[str, Any]] = {}
        self.stages: Dict[str, Dict[str, float]] = {}
        self.executables: Dict[str, Dict[str, Any]] = {}
        self.farm: Dict[str, Any] = {}
        self.mesh: Dict[str, Any] = {}
        self.index: Dict[str, Any] = {}
        self.aot: Dict[str, Any] = {}
        self._compile0 = _compile_snapshot()

    @staticmethod
    def _fingerprints(args: Mapping[str, Any]) -> Dict[str, Optional[str]]:
        """The cache's and resume's identities, each best-effort: an
        unreadable checkpoint fails the build with its own error, and the
        manifest records null."""
        out: Dict[str, Optional[str]] = {
            'config': None, 'weights': None, 'run': None}
        from video_features_torch.cache.key import (
            config_fingerprint, run_fingerprint, weights_fingerprint,
        )
        for name, fn in (('config', config_fingerprint),
                         ('weights', weights_fingerprint),
                         ('run', run_fingerprint)):
            try:
                out[name] = fn(args)
            except Exception:
                pass
        return out

    # -- collectors (called from the extraction loops) -----------------------

    def video_done(self, video_path: str, outcome: str) -> None:
        """Record one video's terminal state."""
        with self._lock:
            self.videos[str(video_path)] = {'outcome': outcome}

    def fold_stages(self, report: Dict[str, Dict[str, float]]) -> None:
        """Merge one ``Tracer.report()`` into the run-wide stage table
        (the loops reset their tracer as they go)."""
        if not report:
            return
        with self._lock:
            self.stages = merge_reports([self.stages, report])

    def note_executable(self, identity: str,
                        info: Dict[str, Any]) -> None:
        """Attach info to one executable identity; later notes merge over
        earlier ones."""
        with self._lock:
            self.executables.setdefault(identity, {}).update(
                {k: _jsonable(v) for k, v in info.items()})

    def note_farm(self, info: Dict[str, Any]) -> None:
        """Record the decode farm of a farm-backed run; later notes merge
        over earlier ones."""
        with self._lock:
            self.farm.update({k: _jsonable(v) for k, v in info.items()})

    def note_mesh(self, info: Dict[str, Any]) -> None:
        """Record the device mesh a mesh-sharded packed run executed on
        (``mesh_devices``, the (data, time) shape, per-device labels,
        per-device capacity against the global batch, the lane); the
        section stays ``{}`` on one device. Later notes merge over earlier
        ones."""
        with self._lock:
            self.mesh.update({k: _jsonable(v) for k, v in info.items()})

    def note_index(self, info: Dict[str, Any]) -> None:
        """Record the feature-index view of a run (``IndexService.stats``
        / ``IndexStore.stats``: rows, shards, ingest lag) — written by runs
        that build or query the index (the offline ``index`` CLI); the
        section stays ``{}`` otherwise. Later notes merge over earlier
        ones."""
        with self._lock:
            self.index.update({k: _jsonable(v) for k, v in info.items()})

    def note_aot(self, info: Dict[str, Any]) -> None:
        """Record the executable store's view of a run
        (``BaseExtractor.aot_snapshot``): which path each kernel library
        took, 'loaded' from the store or 'compiled', with its identity, so
        the manifest shows whether the run's start was compile-free. The
        section stays ``{}`` without ``aot_enabled``. Later notes merge
        over earlier ones."""
        with self._lock:
            self.aot.update({k: _jsonable(v) for k, v in info.items()})

    # -- publication ---------------------------------------------------------

    def document(self) -> Dict[str, Any]:
        compile_delta: Dict[str, Dict[str, float]] = {}
        for name, rec in _compile_snapshot().items():
            base = self._compile0.get(name, {'count': 0, 'total_s': 0.0})
            d_count = rec['count'] - base['count']
            if d_count > 0:
                compile_delta[name] = {
                    'count': int(d_count),
                    'total_s': round(rec['total_s'] - base['total_s'], 6)}
        with self._lock:
            videos = {p: dict(v) for p, v in self.videos.items()}
            stages = {k: dict(v) for k, v in self.stages.items()}
            executables = {k: dict(v) for k, v in self.executables.items()}
            farm = dict(self.farm)
            mesh = dict(self.mesh)
            index = dict(self.index)
            aot = dict(self.aot)
        outcomes: Dict[str, int] = {}
        for v in videos.values():
            outcomes[v['outcome']] = outcomes.get(v['outcome'], 0) + 1
        from video_features_torch import __version__
        return {
            'schema': SCHEMA,
            'version': __version__,
            'started_at_unix_s': round(self._t0, 3),
            'wall_s': round(time.perf_counter() - self._t0_perf, 3),
            'config': self.config,
            'fingerprints': self.fingerprints,
            'videos': videos,
            'outcomes': outcomes,
            'stages': stages,
            'compile': compile_delta,
            'executables': executables,
            'farm': farm,
            # mesh-sharded packed execution: {} on one device
            'mesh': mesh,
            # the feature index's view: {} unless a run noted one
            'index': index,
            # which path each kernel library took: {} without aot_enabled
            'aot': aot,
            # sections the port writes nothing into yet
            'ingress': {}, 'programs_lock': {}, 'slo': {},
        }

    def write(self, path: str) -> str:
        import json
        import os

        from video_features_torch.utils.output import atomic_write
        doc = self.document()
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        atomic_write(path, lambda f: f.write(
            json.dumps(doc, sort_keys=True, indent=1).encode('utf-8')))
        return path
