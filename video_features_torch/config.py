"""Configuration: YAML defaults ← injected pipeline defaults ← dotlist
CLI overrides, then ``sanity_check`` (the i3d, r21d, s3d, raft, resnet,
clip, timm and vggish subset of ``video_features_tpu/config.py``).

Every knob of the JAX package is implemented, so a JAX YAML loads;
:func:`check_common_keys` holds the rules every extractor checks.
The serve daemon's own knobs are :data:`SERVE_DEFAULTS`
(:func:`split_serve_config`), the fleet router's :data:`FLEET_DEFAULTS`
(:func:`split_fleet_config`).
Which knobs can change the extracted bytes is one table,
:data:`KNOB_CLASSIFICATION` (a copy of the JAX package's): the run
fingerprint (``cache/key.py``) leaves out what :func:`knob_exclude`
names and takes in everything else, so an unknown knob costs a
re-extraction, never a wrong resume skip or cache hit.
A fused worklist (``features=[...]``) gets one config per family
(:func:`load_fused_configs`), ``<family>.<knob>=`` scoping a knob to one.

``yaml`` is imported inside the functions that parse, so the package
imports on machines without it.
"""
from __future__ import annotations

import os
import random
import warnings
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple, Union

from video_features_torch.io.video import DECODE_BACKENDS
from video_features_torch.registry import EXTRACTORS, PACKED_FEATURES

CONFIG_DIR = Path(__file__).parent / 'configs'


def _parse_value(raw: str) -> Any:
    """One CLI value with YAML scalar/list semantics: ``null`` → None,
    ``true`` → bool, ``3`` → int, ``[a,b]`` → list, else str."""
    import yaml
    try:
        return yaml.safe_load(raw)
    except yaml.YAMLError:
        return raw


def parse_dotlist(dotlist: Iterable[str]) -> Dict[str, Any]:
    """``['key=value', ...]`` → a dict."""
    cfg = {}
    for item in dotlist:
        if '=' not in item:
            raise ValueError(f'Malformed CLI argument (expected key=value): {item!r}')
        key, _, raw = item.partition('=')
        cfg[key.strip()] = _parse_value(raw)
    return cfg


def load_config(feature_type: Optional[str] = None,
                overrides: Optional[Dict[str, Any]] = None,
                run_sanity_check: bool = True) -> Dict[str, Any]:
    """YAML defaults ← overrides (overrides win), then :func:`sanity_check`."""
    import yaml
    overrides = dict(overrides or {})
    feature_type = feature_type or overrides.get('feature_type')
    if feature_type is None:
        raise ValueError('feature_type must be given (CLI: feature_type=<name>)')
    path = CONFIG_DIR / f'{feature_type}.yml'
    if not path.exists():
        raise NotImplementedError(
            f'Unknown feature_type {feature_type!r}. '
            f'Known: {", ".join(EXTRACTORS)}')
    with open(path) as f:
        args = dict(yaml.safe_load(f) or {})
    for table in (CACHE_DEFAULTS, AOT_DEFAULTS, INDEX_DEFAULTS, OBS_DEFAULTS,
                  PIPELINE_DEFAULTS):
        for key, value in table.items():
            args.setdefault(key, value)
    args.update(overrides)
    if run_sanity_check:
        sanity_check(args)
    return args


def resolve_fused_features(value: Union[str, Iterable[str]]) -> List[str]:
    """A fused worklist's ``features`` value (a list, as the CLI's
    ``features=[resnet,clip]`` parses, or a comma-separated string) as
    the family list in the user's order, duplicates dropped. An unknown
    family, an empty list or another type is a ``ValueError``; one family
    is legal (it runs the single-family path)."""
    if isinstance(value, str):
        items = [s.strip() for s in value.split(',') if s.strip()]
    elif isinstance(value, (list, tuple)):
        items = [str(s).strip() for s in value if str(s).strip()]
    else:
        raise ValueError(
            f'features must be a list of family names or a comma-separated '
            f'string (e.g. features=[resnet,clip,timm]); got {value!r}')
    if not items:
        raise ValueError('features must name at least one feature family')
    families: List[str] = []
    for fam in items:
        if fam not in EXTRACTORS:
            raise ValueError(f'features names unknown family {fam!r} '
                             f'(known: {", ".join(EXTRACTORS)})')
        if fam not in families:
            families.append(fam)
    return families


def split_fused_overrides(overrides: Mapping[str, Any],
                          families: Iterable[str]
                          ) -> Tuple[Dict[str, Any], Dict[str, Dict[str, Any]]]:
    """A fused run's overrides as ``(shared, {family: scoped})``: a
    ``<family>.<knob>=value`` key reaches only that family's config
    (``timm.model_name=vit_base_patch16_224`` while resnet keeps its
    YAML's); ``features`` and ``feature_type`` are dropped, each family
    resolving with its own ``feature_type``."""
    shared: Dict[str, Any] = {}
    scoped: Dict[str, Dict[str, Any]] = {f: {} for f in families}
    for key, value in dict(overrides or {}).items():
        if key in ('features', 'feature_type'):
            continue
        head, dot, rest = key.partition('.')
        if dot and head in scoped and rest:
            scoped[head][rest] = value
        else:
            shared[key] = value
    return shared, scoped


def load_fused_configs(features: Union[str, Iterable[str]],
                       overrides: Optional[Mapping[str, Any]] = None,
                       run_sanity_check: bool = True
                       ) -> Dict[str, Dict[str, Any]]:
    """One merged config per family of ``features``, in the user's order,
    each what ``load_config(family, shared + scoped overrides)`` gives,
    so the output paths, resume fingerprints and files are those of the
    sequential runs. Any invalid family config rejects the whole run
    before work starts."""
    families = resolve_fused_features(features)
    shared, scoped = split_fused_overrides(overrides or {}, families)
    return {fam: load_config(fam, overrides={**shared, **scoped[fam]},
                             run_sanity_check=run_sanity_check)
            for fam in families}


def form_list_from_user_input(
    video_paths: Union[str, List[str], None] = None,
    file_with_video_paths: Optional[str] = None,
    to_shuffle: bool = True,
) -> List[str]:
    """Paths from the config: a path or list, or a file with one path per
    line. Shuffling spreads independent workers over the list."""
    if file_with_video_paths is not None:
        with open(file_with_video_paths) as f:
            path_list = [line.strip() for line in f if line.strip()]
    elif video_paths is None:
        path_list = []
    elif isinstance(video_paths, str):
        path_list = [video_paths]
    else:
        path_list = [str(p) for p in video_paths]
    for path in path_list:
        # a '.live' path is a live session's pseudo-identity
        # (serve/server.py::submit_live): nothing exists at it
        if not path.endswith('.live') and not Path(path).exists():
            warnings.warn(f'path does not exist: {path}')
    if to_shuffle:
        random.shuffle(path_list)
    return path_list


# the content-addressed feature cache (cache/), injected into every merged
# config; off by default. The port's store has a directory of its own
# (the JAX package's default, ~/.cache/video_features_tpu/features, is
# accepted too: the backend tag in every key keeps the two apart)
CACHE_DEFAULTS: Dict[str, Any] = {
    'cache_enabled': False,
    'cache_dir': '~/.cache/video_features_torch/features',
    'cache_max_bytes': None,     # LRU bound in bytes; null = unbounded
    'cache_l2_dir': None,        # a shared second tier behind cache_dir
}

# injected into every merged config, as the JAX package does; a family's
# YAML may carry its own value (i3d ships decode_workers: 2)
PIPELINE_DEFAULTS: Dict[str, Any] = {
    'inflight': 2,               # dispatched steps whose readback is deferred; 1 = synchronous
    'decode_workers': 1,         # per-video loop: transform threads; packed loop: > 1 = the decode farm's processes
    'pack_across_videos': False,  # the batch-major corpus loop (parallel/packing.py)
    'pack_decode_ahead': 2,      # packed decode lookahead, in device batches of windows
    'profile': False,            # stage table on stderr after each video or packed run
    'decode_farm_ring_mb': 64,   # shared-memory ring of each decode farm worker, MiB
}

# the flight recorder (obs/), injected into every merged config with the
# JAX package's defaults; profile_dir (a torch.profiler trace) is off
# when absent, as in the JAX package
OBS_DEFAULTS: Dict[str, Any] = {
    'trace_out': None,           # Chrome trace of the run's spans; null = off
    'trace_capacity': 200_000,   # the span ring's size, in events
    'manifest_out': None,        # the per-run JSON manifest; null = off
    'postmortem_dir': None,      # black-box bundles on a crash; null = off
    'postmortem_max_bytes': 64 * (1 << 20),  # the bundles' size cap
}

# the feature index (index/), injected into every merged config with the
# JAX package's defaults; off by default
INDEX_DEFAULTS: Dict[str, Any] = {
    'index_enabled': False,      # the serve daemon's ingest worker and search
    'index_dir': None,           # null = <cache_dir>/index
    'index_shard_rows': 1024,    # rows per shard file; every shard pads to it
    'index_poll_s': 0.5,         # ingest poll when caught up, seconds
    'index_query_block': 8,      # queries pad to multiples of this
    'index_k_max': 10,           # the largest k a query answers
}

# the executable store (aot/), injected into every merged config with the
# JAX package's defaults but the port's own directory; off by default. A
# stored executable is one kernel library (aot/runtime.py), byte-equal to
# a fresh build, so the knobs stay out of the run fingerprint.
AOT_DEFAULTS: Dict[str, Any] = {
    'aot_enabled': False,        # load kernel libraries from the store
    'aot_dir': '~/.cache/video_features_torch/executables',
    'aot_max_bytes': None,       # LRU bound in bytes; null = unbounded
    'aot_l2_dir': None,          # the fleet's shared tier (fleet/artifacts.py)
}

# Which knobs can change what a run computes (a copy of the JAX package's
# table, classes unchanged, so both packages leave the same keys out of
# their fingerprints):
#   'neither'          — the bytes never depend on it: out of the run
#                        fingerprint and out of a warm-pool key
#   'pool_only'        — where or how a run executes, never the bytes:
#                        out of the fingerprint, in a pool key
#   'fingerprint_only' — in the fingerprint only (unused)
#   'both'             — in both (compute_dtype: a bf16 run computes
#                        other bytes than an fp32 run)
# A knob not listed is in both: the fingerprint fails closed.
KNOB_CLASSIFICATION: Dict[str, str] = {
    # the work list and where outputs land
    'video_paths': 'neither',
    'file_with_video_paths': 'neither',
    'features': 'neither',       # a fused run keys as its solo runs do
    'output_path': 'neither',
    'tmp_path': 'pool_only',
    'keep_tmp_files': 'pool_only',
    # where the program runs and how it is spread
    'device': 'pool_only',
    'device_ids': 'pool_only',
    'data_parallel': 'pool_only',
    'multihost': 'pool_only',
    'coordinator_address': 'pool_only',
    'num_processes': 'pool_only',
    'process_id': 'pool_only',
    'pack_across_videos': 'pool_only',
    'pack_decode_ahead': 'pool_only',
    'mesh_devices': 'pool_only',
    'compute_dtype': 'both',
    'compilation_cache_dir': 'pool_only',
    # decode parallelism and readback depth: the same bytes at any value
    'decode_workers': 'neither',
    'decode_farm_ring_mb': 'neither',
    'inflight': 'neither',
    # observability and debug surfaces
    'profile': 'neither',
    'profile_dir': 'neither',
    'show_pred': 'pool_only',
    'trace_out': 'neither',
    'trace_capacity': 'neither',
    'manifest_out': 'neither',
    'postmortem_dir': 'neither',
    'postmortem_max_bytes': 'neither',
    'watchdog_stall_s': 'neither',
    'slo_latency_p99_s': 'neither',
    'slo_availability': 'neither',
    # the cache's own namespace must not fragment its key space
    'cache_enabled': 'pool_only',
    'cache_dir': 'pool_only',
    'cache_max_bytes': 'pool_only',
    'cache_l2_dir': 'pool_only',
    # the executable store and the feature index
    'aot_enabled': 'pool_only',
    'aot_dir': 'pool_only',
    'aot_max_bytes': 'pool_only',
    'aot_l2_dir': 'pool_only',
    'index_enabled': 'neither',
    'index_dir': 'neither',
    'index_shard_rows': 'neither',
    'index_poll_s': 'neither',
    'index_query_block': 'neither',
    'index_k_max': 'neither',
    # the weights fingerprint hashes the checkpoints' content
    'allow_random_weights': 'pool_only',
    # serving's per-request plumbing
    'timeout_s': 'neither',
    'config': 'pool_only',
}

_KNOB_AXIS_EXCLUDES = {
    'fingerprint': ('neither', 'pool_only'),
    'pool_key': ('neither', 'fingerprint_only'),
}


def knob_exclude(axis: str) -> frozenset:
    """The keys left out of ``axis`` (``'fingerprint'`` | ``'pool_key'``),
    derived from :data:`KNOB_CLASSIFICATION`."""
    excluded = _KNOB_AXIS_EXCLUDES[axis]
    return frozenset(k for k, cls in KNOB_CLASSIFICATION.items()
                     if cls in excluded)

RAFT_FINETUNED_ON = ('sintel', 'kitti')
AUDIO_BACKENDS = ('auto', 'ffmpeg', 'native')


def check_pipeline_keys(args: Mapping[str, Any]) -> Tuple[int, int, int]:
    """``(inflight, decode_workers, decode_farm_ring_mb)``, each an int
    >= 1, as the JAX package requires; ``pack_decode_ahead`` must be >= 1
    too."""
    values = {}
    for key in ('inflight', 'decode_workers', 'decode_farm_ring_mb',
                'pack_decode_ahead'):
        value = args.get(key)
        value = PIPELINE_DEFAULTS[key] if value is None else int(value)
        if value < 1:
            raise ValueError(f'{key} must be >= 1; got {value}')
        values[key] = value
    return (values['inflight'], values['decode_workers'],
            values['decode_farm_ring_mb'])


def check_common_keys(args: Mapping[str, Any]) -> None:
    """The rules every extractor checks on its config: the executable
    store's knobs (:func:`check_aot_keys`), ``decode_backend``, the
    pipeline depths and the lanes."""
    check_aot_keys(args)
    backend = args.get('decode_backend') or 'auto'
    if backend not in DECODE_BACKENDS:
        raise ValueError(f'decode_backend must be one of {DECODE_BACKENDS}; '
                         f'got {backend!r}')
    check_pipeline_keys(args)
    check_lanes(args)


def check_lanes(args: Mapping[str, Any]) -> Tuple[str, str]:
    """``(precision, compute_dtype)`` of a family's config: an unknown
    ``precision`` is a ``ValueError``, ``mixed`` on a family outside
    ``registry.MIXED_FEATURES`` a ``NotImplementedError`` with the card's
    figure, and ``compute_dtype`` goes through ``ops/precision.py::
    check_compute_dtype`` (a ``ValueError`` naming the key)."""
    from video_features_torch.ops.precision import check_compute_dtype
    from video_features_torch.registry import MIXED_FEATURES, MIXED_REFUSALS
    from video_features_torch.utils.device import PRECISIONS
    ft = args.get('feature_type')
    precision = args.get('precision', 'highest')
    if precision not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}; got '
                         f'{precision!r}')
    if precision == 'mixed' and ft is not None and ft not in MIXED_FEATURES:
        raise NotImplementedError(
            f'precision=mixed is not ported for feature_type={ft}: '
            f'{MIXED_REFUSALS.get(ft, "its drift under mixed is not measured")}'
            f'; run with precision=highest, or high for TF32 without the '
            f'parity bar')
    dtype = check_compute_dtype(ft, str(args.get('compute_dtype') or 'float32'))
    return precision, dtype


def check_cache_keys(args: Dict[str, Any]) -> None:
    """The feature cache's rules, as the JAX package's ``sanity_check``
    has them: ``cache_enabled`` needs ``cache_dir``; ``cache_max_bytes``
    is an int >= 0 or null; ``on_extraction=print`` writes nothing to
    address, so it disables the cache with a warning; ``cache_l2_dir``
    needs ``cache_enabled``."""
    if args.get('cache_enabled'):
        if not args.get('cache_dir'):
            raise ValueError('cache_enabled=true requires cache_dir '
                             '(see docs/caching.md)')
        if args.get('cache_max_bytes') is not None:
            args['cache_max_bytes'] = int(args['cache_max_bytes'])
            if args['cache_max_bytes'] < 0:
                raise ValueError('cache_max_bytes must be >= 0 or null; '
                                 f'got {args["cache_max_bytes"]}')
        if args.get('on_extraction') == 'print':
            warnings.warn('cache_enabled has no effect with '
                          'on_extraction=print — disabling the cache')
            args['cache_enabled'] = False
    if args.get('cache_l2_dir') is not None:
        args['cache_l2_dir'] = str(args['cache_l2_dir'])
        if not args.get('cache_enabled'):
            raise ValueError('cache_l2_dir requires cache_enabled=true '
                             '(see docs/fleet.md)')


def check_aot_keys(args: Dict[str, Any]) -> None:
    """The executable store's rules, as the JAX package's ``sanity_check``
    has them (the same messages): ``aot_enabled`` needs ``aot_dir``, which
    coerces to str; ``aot_max_bytes`` is an int >= 0 or null;
    ``aot_l2_dir`` coerces to str and needs ``aot_enabled``.
    ``compilation_cache_dir`` is any directory (``ops/_kernels.py::
    configure_build_dir``)."""
    if args.get('aot_enabled'):
        if not args.get('aot_dir'):
            raise ValueError('aot_enabled=true requires aot_dir '
                             '(see docs/serving.md "Zero cold start")')
    if args.get('aot_dir') is not None:
        args['aot_dir'] = str(args['aot_dir'])
    if args.get('aot_max_bytes') is not None:
        args['aot_max_bytes'] = int(args['aot_max_bytes'])
        if args['aot_max_bytes'] < 0:
            raise ValueError('aot_max_bytes must be >= 0 or null; '
                             f'got {args["aot_max_bytes"]}')
    if args.get('aot_l2_dir') is not None:
        args['aot_l2_dir'] = str(args['aot_l2_dir'])
        if not args.get('aot_enabled'):
            raise ValueError('aot_l2_dir requires aot_enabled=true '
                             '(see docs/fleet.md)')


def check_index_keys(args: Dict[str, Any]) -> None:
    """The feature index's rules, as the JAX package's ``sanity_check``
    has them: the ingest worker tails the cache manifest, so
    ``index_enabled`` needs ``cache_enabled``; the geometry knobs are ints
    >= 1 and ``index_poll_s`` is > 0."""
    if args.get('index_enabled'):
        if not args.get('cache_enabled'):
            raise ValueError('index_enabled=true requires '
                             'cache_enabled=true — the index ingests '
                             'published cache objects '
                             '(see docs/feature_index.md)')
    if args.get('index_dir') is not None:
        args['index_dir'] = str(args['index_dir'])
    for key in ('index_shard_rows', 'index_query_block', 'index_k_max'):
        if args.get(key) is not None:
            args[key] = int(args[key])
            if args[key] < 1:
                raise ValueError(f'{key} must be >= 1; got {args[key]}')
    if args.get('index_poll_s') is not None:
        args['index_poll_s'] = float(args['index_poll_s'])
        if args['index_poll_s'] <= 0:
            raise ValueError('index_poll_s must be > 0 (seconds between '
                             'ingest polls when caught up); got '
                             f'{args["index_poll_s"]}')


def check_obs_keys(args: Dict[str, Any]) -> None:
    """The flight recorder's rules, as the JAX package's ``sanity_check``
    has them: the paths become strings, ``trace_capacity`` and
    ``postmortem_max_bytes`` ints >= 1, ``watchdog_stall_s`` and
    ``slo_latency_p99_s`` floats > 0, ``slo_availability`` a float in
    (0, 1) (a ``ValueError`` otherwise, with the JAX package's text)."""
    for key in ('trace_out', 'manifest_out', 'postmortem_dir'):
        if args.get(key) is not None:
            args[key] = str(args[key])
    for key in ('trace_capacity', 'postmortem_max_bytes'):
        if args.get(key) is not None:
            args[key] = int(args[key])
            if args[key] < 1:
                raise ValueError(f'{key} must be >= 1; got {args[key]}')
    if args.get('watchdog_stall_s') is not None:
        args['watchdog_stall_s'] = float(args['watchdog_stall_s'])
        if args['watchdog_stall_s'] <= 0:
            raise ValueError('watchdog_stall_s must be > 0 (seconds '
                             'without a stage advance before a stall '
                             f'trips); got {args["watchdog_stall_s"]}')
    if args.get('slo_latency_p99_s') is not None:
        args['slo_latency_p99_s'] = float(args['slo_latency_p99_s'])
        if args['slo_latency_p99_s'] <= 0:
            raise ValueError('slo_latency_p99_s must be > 0 (the p99 '
                             'latency objective in seconds); got '
                             f'{args["slo_latency_p99_s"]}')
    if args.get('slo_availability') is not None:
        args['slo_availability'] = float(args['slo_availability'])
        if not 0 < args['slo_availability'] < 1:
            raise ValueError('slo_availability must be in (0, 1), e.g. '
                             f'0.999; got {args["slo_availability"]}')


def check_parallel_keys(args: Dict[str, Any]) -> None:
    """The rules of the parallel knobs, as the JAX package's
    ``sanity_check`` has them: ``device_ids`` warns and is ignored;
    ``mesh_devices`` is an int >= 0 (0: every local device), and yields
    to ``data_parallel`` with a warning; ``data_parallel`` on a family
    outside ``registry.DATA_PARALLEL_FEATURES`` warns and runs on one
    device."""
    if 'device_ids' in args:
        warnings.warn(
            'multi-device single-process extraction is not supported. '
            'Scale out by sharding the video list across workers/hosts '
            f'(device_ids={args["device_ids"]} ignored; using one '
            'accelerator).')
    if args.get('mesh_devices') is not None:
        args['mesh_devices'] = int(args['mesh_devices'])
        if args['mesh_devices'] < 0:
            raise ValueError(
                'mesh_devices must be >= 0 (0 = auto-detect local '
                f'devices, 1 = single device); got {args["mesh_devices"]}')
        if args['mesh_devices'] != 1 and args.get('data_parallel'):
            warnings.warn(
                'mesh_devices and data_parallel both requested — '
                'data_parallel already owns the device mesh, so '
                'mesh_devices is ignored (running mesh_devices=1)')
            args['mesh_devices'] = 1
    ft = args.get('feature_type')
    if args.get('data_parallel'):
        from video_features_torch.registry import DATA_PARALLEL_FEATURES
        if ft not in DATA_PARALLEL_FEATURES:
            warnings.warn(
                f'data_parallel is not implemented for {ft} — running '
                'single-device (scale out with multihost=true / sharded '
                'worklists instead)')
            args['data_parallel'] = False


def gate_packing(args: Dict[str, Any]) -> None:
    """``pack_across_videos`` on a family without a packed loop, or with
    the per-video ``show_pred`` surface, warns and runs the per-video
    loop, as the JAX package does."""
    if not args.get('pack_across_videos'):
        return
    ft = args.get('feature_type')
    if ft not in PACKED_FEATURES:
        warnings.warn(f'pack_across_videos is not implemented for {ft} — '
                      'running the per-video loop')
        args['pack_across_videos'] = False
    elif args.get('show_pred'):
        warnings.warn('show_pred is incompatible with pack_across_videos — '
                      'running the per-video loop')
        args['pack_across_videos'] = False


def check_raft_args(args: Dict[str, Any]) -> None:
    """The raft family's rules."""
    check_common_keys(args)
    if args.get('finetuned_on', 'sintel') not in RAFT_FINETUNED_ON:
        raise ValueError(f'finetuned_on must be one of {RAFT_FINETUNED_ON}; '
                         f'got {args.get("finetuned_on")!r}')
    bucket = args.get('bucket_multiple', 8)
    if not isinstance(bucket, int) or bucket <= 0 or bucket % 8:
        raise ValueError('bucket_multiple must be a positive multiple of 8; '
                         f'got {bucket!r}')
    if args.get('batch_size') is None or int(args['batch_size']) < 1:
        raise ValueError('Please specify `batch_size` (>= 1); got '
                         f'{args.get("batch_size")!r}')


def check_vggish_args(args: Dict[str, Any]) -> None:
    """The vggish family's rules, checked before any weights load.
    ``show_pred`` is refused by the extractor (:mod:`~video_features_torch.
    extract.vggish`), after :func:`sanity_check` has warned."""
    check_common_keys(args)
    backend = args.get('audio_backend') or 'auto'
    if backend not in AUDIO_BACKENDS:
        raise ValueError(f'audio_backend must be one of {AUDIO_BACKENDS}; '
                         f'got {backend!r}')
    if args.get('post_process') and not args.get('pca_params_path'):
        raise ValueError('post_process=true needs '
                         'pca_params_path=<vggish_pca_params.npz>')


def sanity_check(args: Dict[str, Any]) -> None:
    """Validate the merged config and append ``<feature_type>[/<model_name>]``
    ('/' → '_') to the output and tmp paths. The device is resolved here, so a run
    that asks for a GPU on a machine without one fails before any work."""
    from video_features_torch.utils.device import resolve_device
    resolve_device(args.get('device', 'cuda'))
    if not (args.get('file_with_video_paths') or args.get('video_paths')):
        raise ValueError('`video_paths` or `file_with_video_paths` must be specified')
    stems = [Path(p).stem for p in form_list_from_user_input(
        args.get('video_paths'), args.get('file_with_video_paths'),
        to_shuffle=False)]
    if len(stems) != len(set(stems)):
        raise ValueError('Non-unique video filenames (stems collide in the '
                         'flat output dir)')
    ft = args.get('feature_type')
    check_parallel_keys(args)
    gate_packing(args)
    check_cache_keys(args)
    check_index_keys(args)
    check_obs_keys(args)
    if ft == 'raft':
        check_raft_args(args)
    elif ft == 'vggish':
        check_vggish_args(args)
        if args.get('show_pred'):
            warnings.warn('Showing class predictions is not implemented '
                          'for VGGish')
    else:
        check_common_keys(args)
    if ft == 'r21d':
        from video_features_torch.extract.r21d import model_def
        model_def(args.get('model_name'))
    if ft == 'resnet':
        from video_features_torch.models.resnet import arch_def
        arch_def(args.get('model_name'))
    if ft == 'clip' and args.get('model_name') != 'custom':
        from video_features_torch.models.clip import model_def
        model_def(args.get('model_name'))
    if ft == 'timm':
        if args.get('model_name') is None:
            raise ValueError('Please specify `model_name` for timm-style '
                             'models; e.g. `vit_base_patch16_224`')
        from video_features_torch.extract.timm import resolve_model_name
        resolve_model_name(args['model_name'])
    if ft == 'i3d' and args.get('stack_size') is not None \
            and args['stack_size'] < 10:
        raise ValueError('I3D does not support inputs shorter than 10 '
                         f'timestamps. You have: {args["stack_size"]}')
    if args.get('flow_type', 'raft') != 'raft':
        raise NotImplementedError('only flow_type=raft is supported')
    if 'batch_size' in args and args['batch_size'] is None:
        raise ValueError('Please specify `batch_size`')
    if args.get('raft_iters') is not None and int(args['raft_iters']) < 1:
        raise ValueError(f'raft_iters must be >= 1 (got {args["raft_iters"]})')
    if args.get('extraction_fps') is not None \
            and args.get('extraction_total') is not None:
        raise ValueError('`extraction_fps` and `extraction_total` are '
                         'mutually exclusive')
    if 'tmp_path' in args and os.path.relpath(str(args['output_path'])) \
            == os.path.relpath(str(args['tmp_path'])):
        raise ValueError('output_path and tmp_path must differ')
    subs = [ft] if args.get('model_name') is None else [ft, str(args['model_name'])]
    subs = [p.replace('/', '_') for p in subs]
    for key in ('output_path', 'tmp_path'):
        if key in args:
            args[key] = os.path.join(str(args[key]), *subs)


# -- serving (python -m video_features_torch serve) --------------------------

# The server's own knobs (every other key on the serve command line is a
# base override merged under each request's config: device=cuda
# allow_random_weights=true output_path=...). The JAX package's table,
# defaults unchanged.
SERVE_DEFAULTS: Dict[str, Any] = {
    # the loopback JSON-lines endpoint; port 0 = ephemeral, printed at
    # start-up
    'serve_host': '127.0.0.1',
    'serve_port': 0,
    # admission: at most this many videos queued or in flight; a submit
    # that would exceed it is rejected (backpressure), not queued
    'serve_queue_depth': 64,
    # resident extractors (one per pool key), LRU-evicted beyond this
    'serve_warm_pool_size': 4,
    # a worker's feed idle this long with windows pooled flushes them
    # padded: a lone request's tail waits at most this and one step
    'serve_idle_flush_s': 0.05,
    # under continuous traffic, partial pools still flush this often
    'serve_max_batch_wait_s': 2.0,
    # the default per-request deadline (seconds; null = none): videos
    # whose deadline passes before they start decoding expire
    'serve_default_timeout_s': None,
    # the metrics document (and ``<path>.prom``), rewritten atomically on
    # every request completion; null = off
    'serve_metrics_path': None,
    # 'batch' requests see this fraction of serve_queue_depth, so a
    # saturated queue sheds batch before interactive
    'serve_batch_shed_fraction': 0.5,
    # warm-pool entries built at start-up, before the first request:
    # 'family' or 'family@lane' specs
    'serve_prewarm': None,
    # the network front door (ingress/): its HTTP port (null: off, the
    # loopback socket only; 0: ephemeral, printed at start-up)
    'serve_ingress_port': None,
    'serve_ingress_host': '127.0.0.1',
    # the API-key file (JSON or YAML: key → {tenant, priority, rate_rps,
    # burst, max_concurrent}); required with a port, as there is no
    # anonymous mode
    'serve_ingress_auth_file': None,
    # the request-body bound (MiB): a larger body is a structured 413
    'serve_ingress_max_body_mb': 64,
    # concurrent connections; one more is answered 503 at once
    'serve_ingress_max_connections': 64,
}


def split_serve_config(cli_args: Mapping[str, Any]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A serve command line's dotlist as ``(server knobs, base
    overrides)``, validated with the JAX package's rules and error texts:
    an unknown ``serve_*`` key is a ``ValueError`` listing the known ones
    (a typo must not become a per-request override); every other key is a
    base override."""
    serve, base = dict(SERVE_DEFAULTS), {}
    for key, value in dict(cli_args).items():
        if key.startswith('serve_'):
            if key not in SERVE_DEFAULTS:
                raise ValueError(
                    f'Unknown serve option {key!r}. '
                    f'Known: {", ".join(sorted(SERVE_DEFAULTS))}')
            serve[key] = value
        else:
            base[key] = value
    for key in ('serve_queue_depth', 'serve_warm_pool_size'):
        serve[key] = int(serve[key])
        if serve[key] < 1:
            raise ValueError(f'{key} must be >= 1; got {serve[key]}')
    serve['serve_port'] = int(serve['serve_port'])
    for key in ('serve_idle_flush_s', 'serve_max_batch_wait_s'):
        serve[key] = float(serve[key])
        if serve[key] <= 0:
            raise ValueError(f'{key} must be > 0')
    if serve['serve_default_timeout_s'] is not None:
        serve['serve_default_timeout_s'] = \
            float(serve['serve_default_timeout_s'])
    if serve['serve_prewarm'] is not None:
        specs = serve['serve_prewarm']
        if isinstance(specs, str):
            specs = [specs]
        if not isinstance(specs, (list, tuple)) or not all(
                isinstance(s, str) and s.strip() for s in specs):
            raise ValueError(
                "serve_prewarm must be a 'family[@lane]' spec or a list "
                f'of them (e.g. [resnet,resnet@bfloat16]); got '
                f'{serve["serve_prewarm"]!r}')
        specs = [s.strip() for s in specs]
        for spec in specs:
            family = spec.split('@', 1)[0]
            if family == 'index':
                continue
            if family not in PACKED_FEATURES:
                raise ValueError(
                    f'serve_prewarm names unknown or unserveable family '
                    f'{family!r} (serveable: index, '
                    f'{", ".join(sorted(PACKED_FEATURES))})')
        serve['serve_prewarm'] = specs
    serve['serve_batch_shed_fraction'] = \
        float(serve['serve_batch_shed_fraction'])
    if not (0 < serve['serve_batch_shed_fraction'] <= 1):
        raise ValueError('serve_batch_shed_fraction must be in (0, 1]; '
                         f'got {serve["serve_batch_shed_fraction"]}')
    if serve['serve_ingress_port'] is not None:
        serve['serve_ingress_port'] = int(serve['serve_ingress_port'])
        if not serve['serve_ingress_auth_file']:
            raise ValueError(
                'serve_ingress_port requires serve_ingress_auth_file '
                '(an API-key file; see docs/ingress.md) — the network '
                'front door has no anonymous mode')
    for key in ('serve_ingress_max_body_mb',
                'serve_ingress_max_connections'):
        serve[key] = int(serve[key])
        if serve[key] < 1:
            raise ValueError(f'{key} must be >= 1; got {serve[key]}')
    return serve, base


# -- the fleet router (fleet/) ------------------------------------------------
# The router's own knobs, not extraction config: the `fleet` command takes
# only these (its backends own their extraction and serve config), so they
# never merge into a family's config and carry no fingerprint or pool-key
# class. The JAX package's table and defaults.
FLEET_DEFAULTS: Dict[str, Any] = {
    # the backends: a list of host:port serve daemons (a bare port means
    # loopback). Liveness is probed: an unhealthy or draining host leaves
    # the eligible set without a config change
    'fleet_hosts': None,
    # the router's loopback JSON-lines listener (0 = ephemeral)
    'fleet_port': 9310,
    'fleet_host': '127.0.0.1',
    # the HTTP front door (the ingress transport); null = loopback only
    'fleet_http_port': None,
    'fleet_http_host': '127.0.0.1',
    # its API-key file, required with a port: no anonymous mode
    'fleet_auth_file': None,
    # the health probe's period; the probe reads each backend's draining
    'fleet_probe_interval_s': 2.0,
    # how many ring hosts one request may try
    'fleet_max_attempts': 3,
    # the backoff between ring hosts (doubling, capped)
    'fleet_backoff_base_s': 0.05,
    # the connect deadline per backend on the request path
    'fleet_connect_timeout_s': 2.0,
    # virtual nodes per host on the consistent-hash ring
    'fleet_ring_replicas': 64,
    # the fleet's SLOs over the router's routed requests, always on
    'fleet_slo_latency_p99_s': 30.0,
    'fleet_slo_availability': 0.999,
}


def split_fleet_config(cli_args: Mapping[str, Any]
                       ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """A fleet command line's dotlist as ``(router knobs, leftovers)``,
    validated with the JAX package's rules and error texts; the leftovers
    are returned for ``fleet_main`` to refuse (the router forwards
    requests and owns no extraction config)."""
    fleet, extra = dict(FLEET_DEFAULTS), {}
    for key, value in dict(cli_args).items():
        if key.startswith('fleet_'):
            if key not in FLEET_DEFAULTS:
                raise ValueError(
                    f'Unknown fleet option {key!r}. '
                    f'Known: {", ".join(sorted(FLEET_DEFAULTS))}')
            fleet[key] = value
        else:
            extra[key] = value
    if fleet['fleet_hosts'] is not None:
        hosts = fleet['fleet_hosts']
        if isinstance(hosts, (str, int)):
            hosts = [hosts]
        if not isinstance(hosts, (list, tuple)) or not hosts:
            raise ValueError(
                'fleet_hosts must be a host:port (or bare-port) list, '
                f'e.g. [127.0.0.1:9301,127.0.0.1:9302]; got '
                f'{fleet["fleet_hosts"]!r}')
        fleet['fleet_hosts'] = [str(h) for h in hosts]
    for key in ('fleet_port', 'fleet_max_attempts', 'fleet_ring_replicas'):
        fleet[key] = int(fleet[key])
    if fleet['fleet_port'] < 0:
        raise ValueError(f'fleet_port must be >= 0; got {fleet["fleet_port"]}')
    for key in ('fleet_max_attempts', 'fleet_ring_replicas'):
        if fleet[key] < 1:
            raise ValueError(f'{key} must be >= 1; got {fleet[key]}')
    for key in ('fleet_probe_interval_s', 'fleet_backoff_base_s',
                'fleet_connect_timeout_s', 'fleet_slo_latency_p99_s'):
        fleet[key] = float(fleet[key])
        if fleet[key] <= 0:
            raise ValueError(f'{key} must be > 0; got {fleet[key]}')
    fleet['fleet_slo_availability'] = float(fleet['fleet_slo_availability'])
    if not 0 < fleet['fleet_slo_availability'] < 1:
        raise ValueError('fleet_slo_availability must be in (0, 1), '
                         f'e.g. 0.999; got {fleet["fleet_slo_availability"]}')
    if fleet['fleet_http_port'] is not None:
        fleet['fleet_http_port'] = int(fleet['fleet_http_port'])
        if not fleet['fleet_auth_file']:
            raise ValueError(
                'fleet_http_port requires fleet_auth_file (an API-key '
                'file; see docs/ingress.md) — the fleet front door has '
                'no anonymous mode either')
    return fleet, extra
