"""The port's config rules for the r21d, s3d, i3d, raft, resnet, clip,
timm and vggish families (video_features_torch/config.py, configs/*.yml) and the resume
fingerprint (its keys, and checkpoints entering by their content), on
the CPU."""
import os
import shutil

import numpy as np
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_torch.cache.key import run_fingerprint
from video_features_torch.config import knob_exclude, load_config
from video_features_torch.extract.clip import ExtractCLIP
from video_features_torch.extract.r21d import MODEL_CFGS, ExtractR21D
from video_features_torch.extract.resnet import ExtractResNet
from video_features_torch.extract.s3d import ExtractS3D
from video_features_torch.extract.timm import ExtractTIMM
from video_features_torch.extract.vggish import ExtractVGGish
from video_features_torch.models import clip as clip_model
from video_features_torch.models import resnet as resnet_model
from video_features_torch.registry import EXTRACTORS


@pytest.fixture(scope='module')
def clip(tmp_path_factory):
    return write_noise_clip(tmp_path_factory.mktemp('cfg') / 'v.mp4', 3)


def test_defaults(clip, tmp_path):
    base = {'video_paths': clip, 'device': 'cpu', 'output_path': str(tmp_path)}
    r = load_config('r21d', overrides=base)
    assert (r['model_name'], r['stack_size'], r['step_size'], r['batch_size'],
            r['precision'], r['on_extraction']) == (
        'r2plus1d_18_16_kinetics', None, None, 4, 'highest', 'print')
    s = load_config('s3d', overrides=base)
    assert (s['stack_size'], s['step_size'], s['extraction_fps'],
            s['batch_size'], s['on_extraction']) == (64, 64, 25, 1, 'print')
    i = load_config('i3d', overrides=base)
    assert (i['device_resize'], i['show_pred']) == (False, False)
    rn = load_config('resnet', overrides=base)
    assert (rn['model_name'], rn['batch_size'], rn['extraction_fps'],
            rn['on_extraction']) == ('resnet50', 1, None, 'print')
    c = load_config('clip', overrides=base)
    assert (c['model_name'], c['batch_size'], c['pred_texts']) == (
        'ViT-B/32', 1, None)
    t = load_config('timm', overrides=dict(base, model_name='vit_base_patch16_224'))
    assert (t['batch_size'], t['pretrained'], t['image_size'],
            t['sequence_parallel'], t['on_extraction']) == (1, True, None, False, 'print')
    v = load_config('vggish', overrides=base)
    assert (v['batch_size'], v['precision'], v['audio_backend'], v['post_process'],
            v['pca_params_path'], v['keep_tmp_files'], v['on_extraction']) == (
        32, 'highest', 'auto', False, None, False, 'print')
    assert 'compilation_cache_dir' not in v
    assert list(EXTRACTORS) == ['i3d', 'r21d', 's3d', 'raft', 'resnet', 'clip',
                                'timm', 'vggish']
    for ft in EXTRACTORS:
        args = load_config(ft, overrides=dict(base, device='cuda'),
                           run_sanity_check=False)
        assert args['device'] == 'cuda'


@pytest.mark.parametrize('ft,model_name,sub', [
    ('r21d', None, ('r21d', 'r2plus1d_18_16_kinetics')),
    ('r21d', 'r2plus1d_34_8_ig65m_ft_kinetics',
     ('r21d', 'r2plus1d_34_8_ig65m_ft_kinetics')),
    ('s3d', None, ('s3d',)),
    ('s3d', 'a/b', ('s3d', 'a_b')),          # '/' → '_'
    ('resnet', None, ('resnet', 'resnet50')),
    ('resnet', 'resnext101_64x4d', ('resnet', 'resnext101_64x4d')),
    ('clip', None, ('clip', 'ViT-B_32')),
    ('clip', 'ViT-L/14@336px', ('clip', 'ViT-L_14@336px')),
    ('clip', 'custom', ('clip', 'custom')),
    ('timm', 'vit_base_patch16_224', ('timm', 'vit_base_patch16_224')),
    ('vggish', None, ('vggish',)),
    # an hf-hub id keeps its ':'
    ('timm', 'hf_hub:timm/vit_base_patch16_224.augreg_in21k',
     ('timm', 'hf_hub:timm_vit_base_patch16_224.augreg_in21k')),
])
def test_output_subdirectory(clip, tmp_path, ft, model_name, sub):
    """``<out>/<feature_type>[/<model_name>]`` with '/' → '_', and the
    same under ``tmp_path``."""
    overrides = {'video_paths': clip, 'device': 'cpu', 'output_path': str(tmp_path),
                 'tmp_path': str(tmp_path / 'tmp')}
    if model_name is not None:
        overrides['model_name'] = model_name
    args = load_config(ft, overrides=overrides)
    assert args['output_path'] == str(tmp_path.joinpath(*sub))
    assert args['tmp_path'] == str(tmp_path.joinpath('tmp', *sub))


def test_bad_model_name_lists_the_valid_ones(clip):
    with pytest.raises(ValueError, match='r2plus1d_34_32_ig65m_ft_kinetics') as e:
        load_config('r21d', overrides={'video_paths': clip, 'device': 'cpu',
                                       'model_name': 'r2plus1d_50'})
    assert all(name in str(e.value) for name in MODEL_CFGS)


@pytest.mark.parametrize('ft,bad,valid', [
    ('resnet', 'resnet200', resnet_model.ARCHS),
    ('clip', 'ViT-H/14', clip_model.VISUAL_CFGS),
])
def test_bad_frame_wise_model_name_lists_the_valid_ones(clip, ft, bad, valid):
    with pytest.raises(ValueError, match='model_name must be one of') as e:
        load_config(ft, overrides={'video_paths': clip, 'device': 'cpu',
                                   'model_name': bad})
    assert all(name in str(e.value) for name in valid)


@pytest.mark.parametrize('ft', ['resnet', 'clip'])
def test_extraction_fps_and_total_are_exclusive(clip, ft):
    with pytest.raises(ValueError, match='mutually exclusive'):
        load_config(ft, overrides={'video_paths': clip, 'device': 'cpu',
                                   'extraction_fps': 5, 'extraction_total': 10})


def test_output_and_tmp_paths_must_differ(clip, tmp_path):
    with pytest.raises(ValueError, match='tmp_path'):
        load_config('resnet', overrides={'video_paths': clip, 'device': 'cpu',
                                         'output_path': str(tmp_path),
                                         'tmp_path': str(tmp_path)})


@pytest.mark.parametrize('ft', ['i3d', 'r21d', 's3d', 'resnet', 'clip'])
@pytest.mark.parametrize('key,value', [('aot_enabled', True)])
def test_unported_keys_raise_naming_themselves(clip, ft, key, value):
    with pytest.raises(NotImplementedError, match=key):
        load_config(ft, overrides={'video_paths': clip, 'device': 'cpu',
                                   key: value})


VIDEO_FAMILIES = ('i3d', 'r21d', 's3d', 'raft', 'resnet', 'clip', 'timm')


@pytest.mark.parametrize('ft', VIDEO_FAMILIES)
def test_decode_backend_native_is_accepted(clip, ft):
    """Every video family accepts the native decoder (io/native.py) and
    hands its decode_backend to the loader; an unknown one is a
    ValueError naming the key."""
    args = load_config(ft, overrides=_family_overrides(clip, ft,
                                                       decode_backend='native'))
    assert args['decode_backend'] == 'native'
    with pytest.raises(ValueError, match='decode_backend must be one of'):
        load_config(ft, overrides=_family_overrides(clip, ft, decode_backend='pyav'))


@pytest.mark.parametrize('ft,cls', [('r21d', ExtractR21D), ('s3d', ExtractS3D),
                                    ('resnet', ExtractResNet), ('clip', ExtractCLIP),
                                    ('vggish', ExtractVGGish)])
def test_no_gpu_without_device_cpu_is_an_error(clip, tmp_path, ft, cls):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='device=cpu'):
        load_config(ft, overrides={'video_paths': clip})
    with pytest.raises(RuntimeError, match='device=cpu'):
        cls({'feature_type': ft, 'on_extraction': 'print', 'device': 'cuda',
             'output_path': str(tmp_path), 'allow_random_weights': True})


@pytest.mark.parametrize('ft,key,a,b', [
    ('i3d', 'device_resize', False, True),
    ('r21d', 'model_name', 'r2plus1d_18_16_kinetics',
     'r2plus1d_34_32_ig65m_ft_kinetics'),
    ('r21d', 'stack_size', None, 8),
    ('s3d', 'extraction_fps', 25, None),
    ('s3d', 'checkpoint_path', None, 's3d.pt'),
    ('resnet', 'model_name', 'resnet50', 'resnext50_32x4d'),
    ('clip', 'extraction_total', None, 100),
    ('timm', 'image_size', None, 768),
    ('timm', 'model_name', 'vit_base_patch16_224', 'deit_base_patch16_224'),
    ('vggish', 'audio_backend', 'ffmpeg', 'native'),
    ('vggish', 'post_process', False, True),
    ('vggish', 'pca_params_path', None, 'pca.npz'),
    ('vggish', 'checkpoint_path', None, 'vggish.pth'),
])
def test_fingerprint_keys(tmp_path, ft, key, a, b):
    """The config values that shape a family's features (or, for
    device_resize, its pipeline's inputs) change its resume fingerprint;
    a checkpoint or PCA path enters by its file's content (a file written
    here) against a null path's ``random`` or ``none``."""
    assert key not in knob_exclude('fingerprint')
    if key.endswith(('checkpoint_path', 'pca_params_path')):
        b = tmp_path / b
        b.write_bytes(b'weights')
    assert run_fingerprint({'feature_type': ft, key: a}) != \
        run_fingerprint({'feature_type': ft, key: b})


PORTED = ('i3d', 'r21d', 's3d', 'raft', 'resnet', 'clip', 'timm', 'vggish')


def _family_overrides(clip, ft, **extra):
    overrides = {'video_paths': clip, 'device': 'cpu', **extra}
    if ft == 'timm':
        overrides['model_name'] = 'vit_tiny_patch16_224'
    return overrides


@pytest.mark.parametrize('ft', PORTED)
@pytest.mark.parametrize('dtype', ['bfloat16', 'int8'])
def test_compute_dtype_fast_lanes_are_refused(clip, ft, dtype):
    """The bf16 and int8 lanes are refused where the JAX package refuses
    them, naming the key and echoing the value, and taken where it
    admits them."""
    from video_features_tpu import registry as jax_registry
    admits = (jax_registry.BF16_FEATURES if dtype == 'bfloat16'
              else jax_registry.INT8_FEATURES)
    overrides = _family_overrides(clip, ft, compute_dtype=dtype)
    if ft in admits:
        assert load_config(ft, overrides=overrides)['compute_dtype'] == dtype
        return
    with pytest.raises(ValueError, match=f'compute_dtype={dtype} is refused'):
        load_config(ft, overrides=overrides)


@pytest.mark.parametrize('ft', PORTED)
@pytest.mark.parametrize('dtype', ['float32', None])
def test_compute_dtype_float32_is_accepted(clip, ft, dtype):
    args = load_config(ft, overrides=_family_overrides(clip, ft, compute_dtype=dtype))
    assert args['compute_dtype'] == dtype


@pytest.mark.parametrize('dtype', ['float16', 'fp8'])
def test_unknown_compute_dtype_is_a_value_error(clip, dtype):
    with pytest.raises(ValueError, match='compute_dtype must be one of'):
        load_config('resnet', overrides=_family_overrides(clip, 'resnet',
                                                          compute_dtype=dtype))


def test_frame_wise_extractors_refuse_compute_dtype_without_load_config(tmp_path):
    """The extractors check the key themselves too, as they do the other
    unported keys: an fp8 lane is refused by name."""
    for cls, extra in ((ExtractResNet, {'model_name': 'resnet18'}),
                       (ExtractTIMM, {'model_name': 'vit_tiny_patch16_224'})):
        with pytest.raises(ValueError, match="compute_dtype must be one of .*got 'fp8'"):
            cls({'feature_type': cls.__name__[7:].lower(), 'device': 'cpu',
                 'compute_dtype': 'fp8', 'allow_random_weights': True,
                 'output_path': str(tmp_path), **extra})


@pytest.mark.parametrize('key,value', [('index_enabled', True),
                                       ('aot_enabled', True)])
def test_timm_unported_keys_raise_naming_themselves(clip, key, value):
    with pytest.raises(NotImplementedError, match=key):
        load_config('timm', overrides=_family_overrides(clip, 'timm', **{key: value}))


def test_timm_without_a_gpu_is_an_error(clip, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='device=cpu'):
        load_config('timm', overrides={'video_paths': clip,
                                       'model_name': 'vit_tiny_patch16_224'})
    with pytest.raises(RuntimeError, match='device=cpu'):
        ExtractTIMM({'feature_type': 'timm', 'model_name': 'vit_tiny_patch16_224',
                     'device': 'cuda', 'output_path': str(tmp_path),
                     'allow_random_weights': True})


def test_batch_size_is_not_in_the_fingerprint():
    """The port's former allow-list left ``batch_size`` out of the
    fingerprint; it now follows the JAX package's rule, where every key
    its knob table does not exclude enters, ``batch_size`` included."""
    from video_features_tpu.cache.key import config_fingerprint as jax_cfg
    for ft in ('resnet', 'clip'):
        assert run_fingerprint({'feature_type': ft, 'batch_size': 1}) != \
            run_fingerprint({'feature_type': ft, 'batch_size': 32})
        assert jax_cfg({'feature_type': ft, 'batch_size': 1}) != \
            jax_cfg({'feature_type': ft, 'batch_size': 32})


def test_checkpoint_path_string_is_not_in_the_fingerprint(tmp_path):
    """Only the file's content counts: the same bytes under two names
    give one fingerprint, a rewrite under one name changes it."""
    one, two = tmp_path / 'a.pt', tmp_path / 'b.pt'
    one.write_bytes(b'v1')
    two.write_bytes(b'v1')
    fp = run_fingerprint({'checkpoint_path': str(one)})
    assert run_fingerprint({'checkpoint_path': str(two)}) == fp
    one.write_bytes(b'v2')
    # a same-size rewrite within one mtime tick keeps the hash memo's
    # stat identity; a real rewrite moves the mtime
    os.utime(one, ns=(1, 1))
    assert run_fingerprint({'checkpoint_path': str(one)}) != fp


def test_clip_custom_keys_on_the_implicit_checkpoint(tmp_path, monkeypatch):
    """model_name=custom with no path loads ./checkpoints/CLIP-custom.pth,
    so its content is the weights' identity, not ``random``."""
    monkeypatch.chdir(tmp_path)
    args = {'feature_type': 'clip', 'model_name': 'custom', 'checkpoint_path': None}
    missing = run_fingerprint(args)
    (tmp_path / 'checkpoints').mkdir()
    implicit = tmp_path / 'checkpoints' / 'CLIP-custom.pth'
    implicit.write_bytes(b'v1')
    v1 = run_fingerprint(args)
    implicit.write_bytes(b'v2')
    os.utime(implicit, ns=(1, 1))      # as a rewrite a tick later would
    assert len({missing, v1, run_fingerprint(args)}) == 3


def _resnet18(tmp_path, ckpt):
    return ExtractResNet({
        'feature_type': 'resnet', 'model_name': 'resnet18', 'batch_size': 4,
        'checkpoint_path': str(ckpt), 'device': 'cpu',
        'on_extraction': 'save_numpy', 'output_path': str(tmp_path / 'out'),
        'tmp_path': str(tmp_path / 'tmp')})


def _save_resnet18(path, seed):
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet_model.init_state_dict(seed=seed, arch='resnet18').items()},
               path)


def test_checkpoint_rewritten_in_place_re_extracts(clip, tmp_path):
    """A resnet18 run's outputs, then its checkpoint overwritten at the
    same path: the next run does not skip them, and writes new features."""
    ckpt = tmp_path / 'resnet18.pt'
    _save_resnet18(ckpt, seed=0)
    first = _resnet18(tmp_path, ckpt)
    first._extract(clip)
    assert first.is_already_exist(clip)
    saved = tmp_path / 'out' / 'v_resnet.npy'
    old = np.load(saved)
    _save_resnet18(ckpt, seed=1)
    second = _resnet18(tmp_path, ckpt)
    with pytest.warns(UserWarning, match='different config/checkpoint'):
        assert not second.is_already_exist(clip)
    second._extract(clip)
    assert not np.array_equal(np.load(saved), old)
    assert second.is_already_exist(clip)


def test_same_checkpoint_bytes_at_a_new_path_skip(clip, tmp_path, capsys):
    ckpt = tmp_path / 'resnet18.pt'
    _save_resnet18(ckpt, seed=0)
    _resnet18(tmp_path, ckpt)._extract(clip)
    moved = tmp_path / 'elsewhere.pt'
    shutil.copyfile(ckpt, moved)
    capsys.readouterr()
    assert _resnet18(tmp_path, moved).is_already_exist(clip)
    assert 'already exist' in capsys.readouterr().out


# -- the JAX package's knobs: ported, or refused by name ---------------------

def _jax_knobs():
    """Every knob the JAX package injects into a merged config or
    classifies, with its default (None where it injects none)."""
    from video_features_tpu import config as jax_config
    knobs = {}
    for table in (jax_config.CACHE_DEFAULTS, jax_config.AOT_DEFAULTS,
                  jax_config.INDEX_DEFAULTS, jax_config.OBS_DEFAULTS,
                  jax_config.PIPELINE_DEFAULTS, jax_config.FARM_DEFAULTS):
        knobs.update(table)
    for key in jax_config.KNOB_CLASSIFICATION:
        knobs.setdefault(key, None)
    return knobs


# what the port implements of them (compilation_cache_dir: its default or
# null, the port keeping no XLA cache)
PORT_IMPLEMENTS = {'video_paths', 'file_with_video_paths', 'output_path',
                   'tmp_path', 'keep_tmp_files', 'device', 'show_pred',
                   'allow_random_weights', 'compute_dtype', 'inflight',
                   'decode_workers', 'pack_across_videos', 'pack_decode_ahead',
                   'profile', 'compilation_cache_dir', 'decode_farm_ring_mb',
                   'features', 'cache_enabled', 'cache_dir', 'cache_max_bytes',
                   'cache_l2_dir', 'trace_out', 'trace_capacity', 'manifest_out',
                   'postmortem_dir', 'postmortem_max_bytes', 'profile_dir',
                   'mesh_devices', 'device_ids', 'multihost',
                   'coordinator_address', 'num_processes', 'process_id',
                   'data_parallel', 'watchdog_stall_s', 'slo_latency_p99_s',
                   'slo_availability', 'timeout_s', 'config'}
# the keys that left the refused table when several processes and devices
# were ported (sequence_parallel is a key of the JAX timm YAML, not a
# classified knob)
PARALLEL_KEYS = {'mesh_devices', 'device_ids', 'multihost',
                 'coordinator_address', 'num_processes', 'process_id',
                 'data_parallel', 'sequence_parallel'}


def test_every_jax_knob_is_ported_or_refused_at_the_jax_default():
    """The port's table of refused knobs is the JAX package's knobs less
    what the port implements, each at the JAX package's default; a knob
    the JAX package adds fails this test until the port takes a side."""
    from video_features_torch.config import UNPORTED_DEFAULTS
    knobs = _jax_knobs()
    assert set(knobs) - PORT_IMPLEMENTS == set(UNPORTED_DEFAULTS)
    assert not PARALLEL_KEYS & set(UNPORTED_DEFAULTS)
    assert PARALLEL_KEYS - {'sequence_parallel'} <= set(knobs)
    for key, default in UNPORTED_DEFAULTS.items():
        # a knob the JAX package injects no default for is off when absent
        assert knobs.get(key) in ((default, None) if not default else (default,)), key


def _other_value(default):
    if isinstance(default, bool):
        return not default
    if default is None:
        return 'x'
    if isinstance(default, (int, float)):
        return default + 1
    return default + '_elsewhere'


def _refused():
    from video_features_torch.config import UNPORTED_DEFAULTS
    return [(k, _other_value(v)) for k, v in sorted(UNPORTED_DEFAULTS.items())] + [
        ('compilation_cache_dir', '/tmp/xla')]


@pytest.mark.parametrize('key,value', _refused())
def test_every_unported_jax_key_raises_naming_itself(clip, key, value):
    with pytest.raises(NotImplementedError, match=key):
        load_config('resnet', overrides=_family_overrides(clip, 'resnet', **{key: value}))


@pytest.mark.parametrize('ft', PORTED)
def test_a_jax_yaml_of_defaults_loads(clip, tmp_path, ft):
    """The JAX package's YAML for the family, with every knob it injects
    at its default, loads in the port (its device set to the CPU)."""
    import yaml
    from video_features_tpu.config import CONFIG_DIR
    overrides = {k: v for k, v in _jax_knobs().items() if v is not None}
    overrides.update(yaml.safe_load((CONFIG_DIR / f'{ft}.yml').read_text()))
    overrides.update(_family_overrides(clip, ft, output_path=str(tmp_path),
                                       tmp_path=str(tmp_path / 'tmp')))
    args = load_config(ft, overrides=overrides)
    assert args['inflight'] == 2 and args['pack_across_videos'] is False


@pytest.mark.parametrize('key', ['inflight', 'decode_workers', 'pack_decode_ahead',
                                 'decode_farm_ring_mb'])
@pytest.mark.parametrize('value', [0, -1])
def test_pipeline_depths_must_be_positive(clip, key, value):
    with pytest.raises(ValueError, match=f'{key} must be >= 1'):
        load_config('resnet', overrides=_family_overrides(clip, 'resnet', **{key: value}))


OBS_KEYS = {'trace_out': 'x.json', 'trace_capacity': 10, 'manifest_out': 'm.json',
            'postmortem_dir': 'pm', 'postmortem_max_bytes': 1024,
            'profile_dir': 'prof'}


@pytest.mark.parametrize('key', sorted(OBS_KEYS))
def test_flight_recorder_keys_are_taken(clip, key):
    """The flight recorder's six knobs load away from their defaults, and
    the merged config carries the JAX package's injected defaults."""
    args = load_config('resnet', overrides=_family_overrides(
        clip, 'resnet', **{key: OBS_KEYS[key]}))
    assert args[key] == OBS_KEYS[key]
    from video_features_tpu.config import OBS_DEFAULTS as JAX_OBS
    for k in ('trace_out', 'trace_capacity', 'manifest_out', 'postmortem_dir',
              'postmortem_max_bytes'):
        if k != key:
            assert args[k] == JAX_OBS[k], k


@pytest.mark.parametrize('key', ['trace_capacity', 'postmortem_max_bytes'])
@pytest.mark.parametrize('value', [0, -5])
def test_flight_recorder_bounds_raise_as_the_jax_package(clip, key, value):
    """The JAX package's rule and message: a bound below 1 is a
    ValueError, in both packages."""
    from video_features_tpu.config import sanity_check as jax_sanity_check
    with pytest.raises(ValueError, match=f'{key} must be >= 1; got {value}'):
        load_config('resnet', overrides=_family_overrides(clip, 'resnet',
                                                          **{key: value}))
    jax_args = {'feature_type': 'resnet', 'model_name': 'resnet18',
                'video_paths': [str(clip)], 'device': 'cpu',
                'output_path': 'o', 'tmp_path': 't', key: value}
    with pytest.raises(ValueError, match=f'{key} must be >= 1; got {value}'):
        jax_sanity_check(jax_args)


def test_flight_recorder_paths_become_strings(clip, tmp_path):
    args = load_config('resnet', overrides=_family_overrides(
        clip, 'resnet', trace_out=tmp_path / 't.json',
        manifest_out=tmp_path / 'm.json', postmortem_dir=tmp_path / 'pm',
        trace_capacity='12'))
    assert (args['trace_out'], args['manifest_out'], args['postmortem_dir'],
            args['trace_capacity']) == (str(tmp_path / 't.json'),
                                        str(tmp_path / 'm.json'),
                                        str(tmp_path / 'pm'), 12)


@pytest.mark.parametrize('key,value', [('watchdog_stall_s', 5.0),
                                       ('slo_latency_p99_s', 2.0),
                                       ('slo_availability', 0.999)])
def test_watchdog_and_slo_knobs_validate_as_in_the_jax_package(clip, key,
                                                              value):
    """The stall watchdog and the SLOs came with the serve daemon, their
    one consumer, and are validated as the JAX package validates them: a
    good value loads (as a float), a bad one raises the JAX package's
    ValueError text."""
    from video_features_tpu.config import sanity_check as jax_sanity_check
    args = load_config('resnet', overrides=_family_overrides(
        clip, 'resnet', **{key: str(value)}))
    assert args[key] == value and isinstance(args[key], float)
    bad = 1.5 if key == 'slo_availability' else -1.0
    jax_args = {'feature_type': 'resnet', 'model_name': 'resnet18',
                'video_paths': [str(clip)], 'device': 'cpu',
                'output_path': 'o', 'tmp_path': 't', key: bad}
    with pytest.raises(ValueError) as want:
        jax_sanity_check(jax_args)
    with pytest.raises(ValueError) as got:
        load_config('resnet', overrides=_family_overrides(clip, 'resnet',
                                                          **{key: bad}))
    assert str(got.value) == str(want.value)
    assert str(got.value).startswith(key)


@pytest.mark.parametrize('key,value', [('timeout_s', 5.0),
                                       ('config', 'serve.yml')])
def test_serve_request_keys_load_as_in_the_jax_package(clip, key, value):
    """``timeout_s`` and ``config`` are serve-side plumbing the JAX package
    accepts on any config; the port takes them too, unchanged."""
    args = load_config('resnet', overrides=_family_overrides(
        clip, 'resnet', **{key: value}))
    assert args[key] == value


def test_pipeline_defaults_are_injected(clip):
    """inflight 2, decode_workers 1 (2 for i3d, as its JAX YAML ships),
    packing off, lookahead 2, profile off, farm rings of 64 MiB, in every
    family's config."""
    from video_features_torch.extract.resnet import ExtractResNet
    for ft in PORTED:
        args = load_config(ft, overrides=_family_overrides(clip, ft))
        assert (args['inflight'], args['decode_workers'], args['pack_across_videos'],
                args['pack_decode_ahead'], args['profile'],
                args['decode_farm_ring_mb']) == (
            2, 2 if ft == 'i3d' else 1, False, 2, False, 64), ft
    ex = ExtractResNet({'feature_type': 'resnet', 'model_name': 'resnet18',
                        'device': 'cpu', 'allow_random_weights': True,
                        'output_path': 'unused', 'inflight': 3})
    assert (ex.inflight, ex.decode_workers, ex.decode_farm_ring_mb,
            ex.tracer.enabled) == (3, 1, 64, False)


@pytest.mark.parametrize('ft', ['i3d', 'r21d', 's3d', 'resnet', 'clip', 'timm'])
def test_decode_farm_with_packing_is_accepted(clip, ft):
    """decode_workers > 1 with pack_across_videos is the decode farm, as
    in the JAX package: the merged config keeps both farm knobs."""
    args = load_config(ft, overrides=_family_overrides(
        clip, ft, pack_across_videos=True, decode_workers=3,
        decode_farm_ring_mb=16))
    assert (args['decode_workers'], args['decode_farm_ring_mb'],
            args['pack_across_videos']) == (3, 16, True)
