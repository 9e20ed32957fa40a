"""The port's config rules for the r21d, s3d and i3d families
(video_features_torch/config.py, configs/*.yml) and the resume
fingerprint keys, on the CPU."""
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_torch.config import load_config
from video_features_torch.extract.base import FINGERPRINT_KEYS, run_fingerprint
from video_features_torch.extract.r21d import MODEL_CFGS, ExtractR21D
from video_features_torch.extract.s3d import ExtractS3D
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
    assert list(EXTRACTORS) == ['i3d', 'r21d', 's3d', 'raft']
    for ft in ('i3d', 'r21d', 's3d', 'raft'):
        args = load_config(ft, overrides=dict(base, device='cuda'),
                           run_sanity_check=False)
        assert args['device'] == 'cuda'


@pytest.mark.parametrize('ft,model_name,sub', [
    ('r21d', None, ('r21d', 'r2plus1d_18_16_kinetics')),
    ('r21d', 'r2plus1d_34_8_ig65m_ft_kinetics',
     ('r21d', 'r2plus1d_34_8_ig65m_ft_kinetics')),
    ('s3d', None, ('s3d',)),
    ('s3d', 'a/b', ('s3d', 'a_b')),          # '/' → '_'
])
def test_output_subdirectory(clip, tmp_path, ft, model_name, sub):
    overrides = {'video_paths': clip, 'device': 'cpu', 'output_path': str(tmp_path)}
    if model_name is not None:
        overrides['model_name'] = model_name
    assert load_config(ft, overrides=overrides)['output_path'] == \
        str(tmp_path.joinpath(*sub))


def test_bad_model_name_lists_the_valid_ones(clip):
    with pytest.raises(ValueError, match='r2plus1d_34_32_ig65m_ft_kinetics') as e:
        load_config('r21d', overrides={'video_paths': clip, 'device': 'cpu',
                                       'model_name': 'r2plus1d_50'})
    assert all(name in str(e.value) for name in MODEL_CFGS)


@pytest.mark.parametrize('ft', ['i3d', 'r21d', 's3d'])
@pytest.mark.parametrize('key,value', [('data_parallel', True),
                                       ('decode_backend', 'native'),
                                       ('decode_workers', 2),
                                       ('pack_across_videos', True)])
def test_unported_keys_raise_naming_themselves(clip, ft, key, value):
    with pytest.raises(NotImplementedError, match=key):
        load_config(ft, overrides={'video_paths': clip, 'device': 'cpu',
                                   key: value})


@pytest.mark.parametrize('ft,cls', [('r21d', ExtractR21D), ('s3d', ExtractS3D)])
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
])
def test_fingerprint_keys(ft, key, a, b):
    """The config values that shape a family's features (or, for
    device_resize, its pipeline's inputs) change its resume fingerprint."""
    assert key in FINGERPRINT_KEYS[ft]
    keys = FINGERPRINT_KEYS[ft]
    assert run_fingerprint({key: a}, keys) != run_fingerprint({key: b}, keys)
