"""Configuration: YAML defaults ← dotlist CLI overrides, then
``sanity_check`` (the i3d, r21d, s3d, raft, resnet, clip, timm and
vggish subset of ``video_features_tpu/config.py``).

``yaml`` is imported inside the functions that parse, so the package
imports on machines without it.
"""
from __future__ import annotations

import os
import random
import warnings
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Union

from video_features_torch.io.video import DECODE_BACKENDS
from video_features_torch.registry import EXTRACTORS

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
    args.update(overrides)
    if run_sanity_check:
        sanity_check(args)
    return args


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
        if not Path(path).exists():
            warnings.warn(f'path does not exist: {path}')
    if to_shuffle:
        random.shuffle(path_list)
    return path_list


RAFT_FINETUNED_ON = ('sintel', 'kitti')
# the JAX package's compute_dtype values; the port computes in float32 only
COMPUTE_DTYPES = ('float32', 'bfloat16', 'int8')
AUDIO_BACKENDS = ('auto', 'ffmpeg', 'native')


def check_unported_keys(args: Dict[str, Any]) -> None:
    """Keys of the JAX package's configs that the port does not implement
    yet raise ``NotImplementedError`` naming the key."""
    if args.get('data_parallel'):
        raise NotImplementedError(
            'data_parallel=true is not ported yet: run with data_parallel=false')
    if args.get('pack_across_videos'):
        raise NotImplementedError(
            'pack_across_videos=true is not ported yet: run with '
            'pack_across_videos=false')
    backend = args.get('decode_backend') or 'auto'
    if backend not in DECODE_BACKENDS:
        raise ValueError(f'decode_backend must be one of {DECODE_BACKENDS}; '
                         f'got {backend!r}')
    if int(args.get('decode_workers') or 1) > 1:
        raise NotImplementedError(
            'decode_workers > 1 is not ported yet: run with decode_workers=1')
    if args.get('sequence_parallel'):
        raise NotImplementedError(
            'sequence_parallel=true is not ported yet (ROADMAP Queue A 4: '
            'ring attention over several GPUs): run with '
            'sequence_parallel=false; one GPU attends long token sequences '
            'blockwise')
    dtype = args.get('compute_dtype')
    if dtype is not None and dtype != 'float32':
        if dtype not in COMPUTE_DTYPES:
            raise ValueError(f'compute_dtype must be one of {COMPUTE_DTYPES}; '
                             f'got {dtype!r}')
        raise NotImplementedError(
            f'compute_dtype={dtype} is not ported yet (ROADMAP Queue A 5, '
            f'precision lanes): the port computes in float32 only; run with '
            f'compute_dtype=float32')


def check_raft_args(args: Dict[str, Any]) -> None:
    """The raft family's rules."""
    check_unported_keys(args)
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
    check_unported_keys(args)
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
    from video_features_torch.utils.device import PRECISIONS, resolve_device
    resolve_device(args.get('device', 'cuda'))
    prec = args.get('precision', 'highest')
    if prec not in PRECISIONS:
        raise ValueError(f'precision must be one of {PRECISIONS}; got {prec!r}')
    if not (args.get('file_with_video_paths') or args.get('video_paths')):
        raise ValueError('`video_paths` or `file_with_video_paths` must be specified')
    stems = [Path(p).stem for p in form_list_from_user_input(
        args.get('video_paths'), args.get('file_with_video_paths'),
        to_shuffle=False)]
    if len(stems) != len(set(stems)):
        raise ValueError('Non-unique video filenames (stems collide in the '
                         'flat output dir)')
    ft = args.get('feature_type')
    if ft == 'raft':
        check_raft_args(args)
    elif ft == 'vggish':
        check_vggish_args(args)
        if args.get('show_pred'):
            warnings.warn('Showing class predictions is not implemented '
                          'for VGGish')
    else:
        check_unported_keys(args)
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
