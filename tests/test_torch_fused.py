"""The port's fused worklists (``features=[...]``:
video_features_torch/config.py's ``resolve_fused_features``,
``split_fused_overrides`` and ``load_fused_configs``,
parallel/packing.py's ``run_packed_fused`` and the CLI route) on the
CPU: the configs are the JAX package's, each family's files are the
bytes of its own packed run, every video is decoded once, in-process
and through the decode farm, the outputs hold the JAX package's fused
run on the same seeded weights, and a family's fault or a decode fault
stays where it belongs."""
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_torch.config import (
    load_fused_configs, resolve_fused_features, split_fused_overrides,
)
from video_features_torch.parallel.packing import FusedTask, run_packed_fused
from video_features_torch.registry import create_extractor

JAX_REL_L2 = 1e-5     # float32 on both sides, different sum orders
FAMILIES = ['resnet', 'clip']


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several workers per machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def _npys(root):
    """{path relative to ``root``: bytes} of every .npy under it."""
    return {str(f.relative_to(root)): f.read_bytes()
            for f in sorted(Path(root).rglob('*.npy'))}


# -- the configs, against the JAX package's -----------------------------------


@pytest.mark.parametrize('value', [
    ['resnet', 'clip'], 'resnet, clip,resnet', ['timm'], ('clip', ' i3d '),
    [], 'resnet,nope', 3, ''])
def test_resolve_fused_features_matches_jax(value):
    from video_features_tpu.config import resolve_fused_features as jax_resolve
    try:
        want = jax_resolve(value)
    except ValueError as e:
        with pytest.raises(ValueError) as got:
            resolve_fused_features(value)
        assert str(got.value).split(' (')[0] == str(e).split(' (')[0]
        return
    assert resolve_fused_features(value) == want


def test_split_fused_overrides_matches_jax():
    """``<family>.<knob>`` reaches that family only; the routing keys are
    dropped; a dotted key of another prefix stays shared."""
    from video_features_tpu.config import split_fused_overrides as jax_split
    overrides = {'features': ['resnet', 'timm'], 'feature_type': 'x',
                 'batch_size': 8, 'timm.model_name': 'vit_base_patch16_224',
                 'resnet.batch_size': 4, 'clip.model_name': 'RN50',
                 'device': 'cpu'}
    shared, scoped = split_fused_overrides(overrides, ['resnet', 'timm'])
    jax_shared, jax_scoped = jax_split(overrides, ['resnet', 'timm'])
    assert shared == dict(jax_shared)
    assert scoped == {f: dict(v) for f, v in jax_scoped.items()}
    assert scoped['timm'] == {'model_name': 'vit_base_patch16_224'}
    assert shared['clip.model_name'] == 'RN50'


@pytest.fixture(scope='module')
def worklist(tmp_path_factory):
    """Three short clips: no family's batch of 4 fills from one alone."""
    d = tmp_path_factory.mktemp('fusedvids')
    return [str(write_noise_clip(d / f'v{i}.mp4', n, w=64, h=48, seed=30 + i))
            for i, n in enumerate((9, 4, 6))]


def _overrides(paths, out, **kw):
    return {'video_paths': paths, 'device': 'cpu', 'allow_random_weights': True,
            'on_extraction': 'save_numpy', 'output_path': str(out),
            'tmp_path': str(out) + '_tmp', 'batch_size': 4,
            'resnet.model_name': 'resnet18', 'clip.model_name': 'ViT-B/32', **kw}


def test_load_fused_configs_matches_jax(worklist, tmp_path):
    """Each family's merged config equals the JAX package's on every key
    they share, scoped keys and output paths included; the default
    ``cache_dir`` is the port's own store (its keys carry a backend tag,
    so the JAX package's directory would serve no hit either)."""
    from video_features_tpu.config import load_fused_configs as jax_load
    overrides = _overrides(worklist, tmp_path, features=FAMILIES)
    ours = load_fused_configs(FAMILIES, overrides)
    theirs = jax_load(FAMILIES, overrides)
    assert list(ours) == list(theirs) == FAMILIES
    for fam in FAMILIES:
        shared = set(ours[fam]) & set(theirs[fam])
        assert {'model_name', 'output_path', 'batch_size', 'decode_workers'} <= shared
        assert ours[fam]['cache_dir'] == '~/.cache/video_features_torch/features'
        shared.discard('cache_dir')
        assert {k: ours[fam][k] for k in shared} == {k: theirs[fam][k] for k in shared}
        assert 'features' not in ours[fam]
    assert ours['resnet']['model_name'] == 'resnet18'
    assert ours['clip']['output_path'] == str(tmp_path / 'clip' / 'ViT-B_32')


def test_load_fused_configs_rejects_the_whole_run_on_one_bad_family(worklist,
                                                                     tmp_path):
    with pytest.raises(ValueError, match='unknown family'):
        load_fused_configs(['resnet', 'nope'], _overrides(worklist, tmp_path))
    with pytest.raises(ValueError, match="model_name must be one of.*'no-such-clip'"):
        load_fused_configs(['resnet', 'clip'], _overrides(
            worklist, tmp_path, **{'clip.model_name': 'no-such-clip'}))


# -- the fused run -----------------------------------------------------------------


@pytest.fixture(scope='module')
def fused(worklist, tmp_path_factory):
    """The two extractors (outputs under ``<root>/<tree>/<family>/...``)
    and each family's solo packed outputs, the reference."""
    root = tmp_path_factory.mktemp('fused')
    configs = load_fused_configs(FAMILIES, _overrides(worklist, root / 'cfg'))
    exs = {fam: create_extractor(args) for fam, args in configs.items()}
    # <family>/<model>, as the CLI lays the trees out
    subs = {fam: Path(args['output_path']).relative_to(root / 'cfg')
            for fam, args in configs.items()}

    def run(tree, fn):
        for fam, ex in exs.items():
            ex.output_path = str(root / tree / subs[fam])
        out = fn()
        return out, _npys(root / tree)

    _, solo = run('solo', lambda: [ex.extract_packed(list(worklist))
                                   for ex in exs.values()])
    return SimpleNamespace(exs=exs, root=root, run=run, solo=solo)


@pytest.mark.parametrize('workers', [1, 2])
def test_fused_run_equals_sequential_and_decodes_once(fused, worklist, workers,
                                                      monkeypatch):
    """resnet18 and CLIP ViT-B/32 over one decode per video write the
    bytes of their solo packed runs, at decode_workers 1 (in-process) and
    2 (the decode farm, which ships one window per frame and family)."""
    from video_features_torch.io import video
    opened = []
    init = video.VideoLoader.__init__

    def counting_init(self, path, *args, **kwargs):
        opened.append(path)
        init(self, path, *args, **kwargs)
    monkeypatch.setattr(video.VideoLoader, '__init__', counting_init)
    for ex in fused.exs.values():
        monkeypatch.setattr(ex, 'decode_workers', workers)
        monkeypatch.setattr(ex, '_farm', None)
    stats, got = fused.run(f'w{workers}',
                           lambda: run_packed_fused(fused.exs, list(worklist)))
    assert got == fused.solo and len(got) == 2 * 3 * len(worklist)
    assert stats == {'videos': 3, 'decode_passes': 3}
    lead = fused.exs['resnet']
    if workers == 1:
        assert sorted(opened) == sorted(worklist) and lead._farm is None
    else:
        assert opened == []       # every decode ran in a worker process
        st = lead._farm.stats()
        assert st['ran'] and st['videos_assigned'] == 3
        assert st['windows'] == 2 * (9 + 4 + 6) and st['queue_fallback'] == 0


def test_fused_run_matches_the_jax_packages(fused, worklist, tmp_path):
    """The port's fused outputs against the JAX package's
    ``run_packed_fused`` on the same seeded weights and clips."""
    from video_features_tpu.config import load_fused_configs as jax_load
    from video_features_tpu.parallel.packing import (
        run_packed_fused as jax_run_packed_fused,
    )
    from video_features_tpu.registry import create_extractor as jax_create
    configs = jax_load(FAMILIES, _overrides(worklist, tmp_path / 'jax',
                                            decode_backend='cv2'))
    jax_run_packed_fused({f: jax_create(a) for f, a in configs.items()},
                         list(worklist))
    _, got = fused.run('vsjax', lambda: run_packed_fused(fused.exs, list(worklist)))
    ref = {str(f.relative_to(tmp_path / 'jax')): np.load(f)
           for f in sorted((tmp_path / 'jax').rglob('*.npy'))}
    assert set(ref) == set(got) and ref
    for key, want in ref.items():
        have = np.load(fused.root / 'vsjax' / key)
        assert have.shape == want.shape, key
        if key.endswith(('_fps.npy', '_timestamps_ms.npy')):
            np.testing.assert_array_equal(have, want)
        else:
            assert rel_l2(have, want) <= JAX_REL_L2, key


def test_fused_family_fault_is_isolated(fused, worklist, monkeypatch, capsys):
    """A family whose steps fail writes nothing; the other family writes
    its solo bytes from the same decode."""
    def broken(batch):
        raise ValueError('clip step broke')
    monkeypatch.setattr(fused.exs['clip'], 'dispatch', broken)
    _, got = fused.run('famfault', lambda: run_packed_fused(fused.exs, list(worklist)))
    assert got == {k: v for k, v in fused.solo.items() if k.startswith('resnet')}
    assert 'clip step broke' in capsys.readouterr().err


@pytest.mark.parametrize('workers', [1, 2])
def test_fused_decode_fault_fails_every_family_for_that_video(
        fused, worklist, tmp_path, workers, monkeypatch, capsys):
    """A video that does not decode fails for both families, alone."""
    for ex in fused.exs.values():
        monkeypatch.setattr(ex, 'decode_workers', workers)
    bad = str(tmp_path / 'gone.mp4')
    paths = worklist[:1] + [bad] + worklist[1:]
    stats, got = fused.run(f'decfault{workers}',
                           lambda: run_packed_fused(fused.exs, paths))
    assert got == fused.solo and stats['videos'] == 4
    assert f'video={bad}' in capsys.readouterr().err


def test_fused_admission_is_per_family(fused, worklist):
    """A family whose outputs exist skips the video and leaves the
    decode's fan-out; a video every family skips is never decoded."""
    root = fused.root / 'resume'
    fused.run('resume', lambda: run_packed_fused(fused.exs, worklist[:1]))
    for f in (root / 'clip').rglob('*.npy'):
        f.unlink()                    # clip redoes video 0; resnet skips it
    stats, got = fused.run('resume', lambda: run_packed_fused(
        fused.exs, [FusedTask(p, FAMILIES) for p in worklist]))
    assert got == fused.solo
    assert stats == {'videos': 3, 'decode_passes': 3}
    stats, got = fused.run('resume', lambda: run_packed_fused(fused.exs, worklist))
    assert stats == {'videos': 3, 'decode_passes': 0} and got == fused.solo


def test_fused_run_refuses_families_that_cannot_share_a_decode(fused):
    unfusable = SimpleNamespace(fused_decode_signature=lambda: None)
    with pytest.raises(ValueError, match='cannot share one decode pass'):
        run_packed_fused({'resnet': fused.exs['resnet'], 'i3d': unfusable}, [])
    with pytest.raises(ValueError, match='at least one family'):
        run_packed_fused({}, [])


def test_cli_features_routes_to_the_fused_run(worklist, tmp_path, capsys, fused):
    """``features=[resnet,clip,r21d]`` on the CLI: resnet and clip share
    one decode and write their solo bytes; r21d (a stack family, no
    signature) runs its own packed pass over the same list."""
    from video_features_torch.cli import main
    out = tmp_path / 'cli'
    assert main(['features=[resnet,clip,r21d]', 'device=cpu',
                 f'video_paths=[{",".join(worklist)}]', 'batch_size=4',
                 'allow_random_weights=true', 'on_extraction=save_numpy',
                 'resnet.model_name=resnet18', 'clip.model_name=ViT-B/32',
                 'r21d.stack_size=4', 'r21d.step_size=4',
                 f'output_path={out}', f'tmp_path={tmp_path / "tmp"}']) == 0
    said = capsys.readouterr().out
    assert 'Fused worklist (3 families): resnet, clip, r21d' in said
    assert 'Fusing decode for [resnet, clip]: one pass over 3 videos' in said
    assert '[r21d] cannot share a decode pass' in said
    got = _npys(out)
    assert {k: v for k, v in got.items() if not k.startswith('r21d')} == fused.solo
    r21d = sorted(k for k in got if k.startswith('r21d'))
    assert len(r21d) == 3
    assert np.load(out / r21d[0]).shape[1] == 512
