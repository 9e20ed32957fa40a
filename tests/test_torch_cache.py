"""The port's content-addressed feature cache (video_features_torch/cache/,
fleet/tier.py, the cache hooks of extract/base.py, parallel/packing.py and
farm/farm.py) on the CPU, against the JAX package's cache/ where both
compute the same thing: one fingerprint that fails closed (the JAX
package's knob table, so ``decode_backend`` and ``batch_size`` enter it),
keys by content with a backend tag, a store whose counters, survivors and
GC reports are the JAX store's on one sequence of operations, and hits
that are byte-identical to the cold run with no step, on the per-video,
packed, farm and fused paths."""
import json
import os
import shutil
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_tpu import config as jax_config
from video_features_tpu.cache import key as jax_key
from video_features_tpu.cache import store as jax_store
from video_features_torch import cli
from video_features_torch.cache import gc as port_gc
from video_features_torch.cache import key, store
from video_features_torch.config import knob_exclude, load_config, load_fused_configs
from video_features_torch.extract.base import BaseExtractor
from video_features_torch.fleet.tier import TieredFeatureCache
from video_features_torch.parallel.packing import VideoTask, run_packed_fused
from video_features_torch.registry import create_extractor
from video_features_torch.utils.fingerprint import (
    hash_file_stats, reset_hash_file_stats,
)
from video_features_torch.utils.tracing import Tracer

PORTED = ('i3d', 'r21d', 's3d', 'raft', 'resnet', 'clip', 'timm', 'vggish')
RESNET_KEYS = ('resnet', 'fps', 'timestamps_ms')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread: the tier-1 run has several workers per machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def clips(tmp_path_factory):
    d = tmp_path_factory.mktemp('cachevids')
    return [str(write_noise_clip(d / f'cv{i}.mp4', n, w=64, h=48, seed=50 + i))
            for i, n in enumerate((9, 5))]


def _resnet_args(paths, out, **kw):
    over = dict(video_paths=paths, device='cpu', model_name='resnet18',
                batch_size=4, allow_random_weights=True,
                on_extraction='save_numpy', output_path=str(out),
                tmp_path=str(out) + '_tmp')
    over.update(kw)
    return load_config('resnet', overrides=over)


def _npys(root):
    """{path relative to ``root``: bytes} of every .npy under it."""
    return {str(f.relative_to(root)): f.read_bytes()
            for f in sorted(Path(root).rglob('*.npy'))}


# -- the fingerprint ---------------------------------------------------------


def test_knob_table_and_exclusions_equal_the_jax_packages():
    """The port's knob table is the JAX package's, and the fingerprint's
    exclusion set is derived from the JAX table, not a hand copy."""
    from video_features_torch.config import KNOB_CLASSIFICATION
    assert KNOB_CLASSIFICATION == jax_config.KNOB_CLASSIFICATION
    jax_excluded = {k for k, cls in jax_config.KNOB_CLASSIFICATION.items()
                    if cls in ('neither', 'pool_only')}
    assert knob_exclude('fingerprint') == jax_excluded == key.CONFIG_KEY_EXCLUDE
    assert knob_exclude('pool_key') == jax_config.knob_exclude('pool_key')


def _family_args(tmp_path, ft, **kw):
    video = tmp_path / 'v.mp4'
    video.touch()
    over = {'video_paths': str(video), 'device': 'cpu',
            'on_extraction': 'save_numpy', 'output_path': str(tmp_path / 'out'),
            'tmp_path': str(tmp_path / 'tmp')}
    if ft == 'timm':
        over['model_name'] = 'vit_tiny_patch16_224'
    over.update(kw)
    return load_config(ft, overrides=over)


@pytest.mark.parametrize('ft', PORTED)
def test_fingerprint_tracks_decode_and_batch_but_not_plumbing(tmp_path, ft):
    """The resume fingerprint's old fault: one value for cv2, native and
    batch 3 in every family. It now changes with ``decode_backend`` (the
    decoded bytes differ) and ``batch_size``, as the JAX package's does,
    and not with output paths, pipeline depths, profiling or the cache's
    own keys."""
    def fp(**kw):
        return key.run_fingerprint(_family_args(tmp_path, ft, **kw))

    base = fp(decode_backend='cv2', batch_size=1)
    assert fp(decode_backend='native', batch_size=1) != base
    assert fp(decode_backend='cv2', batch_size=3) != base
    same = [dict(output_path=str(tmp_path / 'elsewhere')), dict(inflight=5),
            dict(decode_workers=3), dict(profile=True),
            dict(cache_enabled=True, cache_dir=str(tmp_path / 'c'),
                 cache_max_bytes=10 ** 9, cache_l2_dir=str(tmp_path / 'l2'))]
    for kw in same:
        assert fp(decode_backend='cv2', batch_size=1, **kw) == base, kw
    # the reference's fingerprint tells the three apart too
    jax_fp = [jax_key.config_fingerprint({'feature_type': ft, **kw}) for kw in (
        dict(decode_backend='cv2', batch_size=1),
        dict(decode_backend='native', batch_size=1),
        dict(decode_backend='cv2', batch_size=3))]
    assert len(set(jax_fp)) == 3


def test_video_key_is_content_addressed_and_tagged(tmp_path):
    a, b, c = (tmp_path / n for n in ('a.mp4', 'b.mp4', 'c.mp4'))
    a.write_bytes(b'same bytes')
    b.write_bytes(b'same bytes')
    c.write_bytes(b'other bytes')
    k = key.video_cache_key
    assert k(str(a), 'fp') == k(str(b), 'fp') != k(str(c), 'fp')
    assert k(str(a), 'fp') != k(str(a), 'fp2')
    old = k(str(a), 'fp')
    a.write_bytes(b'rewritten!')
    os.utime(a, ns=(1, 1))
    assert k(str(a), 'fp') != old
    # segments: millisecond-quantized, and never the whole video's key
    assert k(str(c), 'fp', (1.0004, 2.0)) == k(str(c), 'fp', (1.0, 2.0))
    assert k(str(c), 'fp', (1.001, 2.0)) != k(str(c), 'fp', (1.0, 2.0))
    assert k(str(c), 'fp', (0.0, 2.0)) != k(str(c), 'fp')
    # the backend tag: a JAX-written entry never answers a port run
    assert k(str(c), 'fp') != jax_key.video_cache_key(str(c), 'fp')
    assert k(str(c), 'fp', (1.0, 2.0)) != \
        jax_key.video_cache_key(str(c), 'fp', (1.0, 2.0))


def test_hash_file_memo_counts_passes(tmp_path):
    f = tmp_path / 'x.bin'
    f.write_bytes(os.urandom(3000))
    reset_hash_file_stats()
    digest = key.hash_file(str(f))
    assert key.hash_file(str(tmp_path / '.' / 'x.bin')) == digest
    assert hash_file_stats() == {'passes': 1, 'memo_hits': 1}
    assert digest == jax_key.hash_file(str(f))


# -- the store, against the JAX package's -------------------------------------


def _drive_store(cls, root: Path, seed: int = 7):
    """One seeded sequence of operations on a store of class ``cls``:
    puts of seeded sizes, fetches, eviction under max_bytes, a truncated
    object, a same-size bit flip, a torn manifest tail. Returns what the
    two packages must agree on."""
    rng = np.random.RandomState(seed)
    srcs = root / 'srcs'
    srcs.mkdir(parents=True)
    cache = cls(str(root / 'store'), max_bytes=6000)
    keys = [f'{i:02x}key{i}' for i in range(8)]
    for i, k in enumerate(keys):
        files = {}
        for name in ('feat', 'fps'):
            src = srcs / f'{k}_{name}.npy'
            src.write_bytes(rng.bytes(int(rng.randint(200, 1200))))
            files[name] = (str(src), '.npy')
        cache.put(k, files, meta={'i': i})
        if i % 3 == 0:
            cache.fetch_to(keys[i // 2], str(root / 'out'), f'/v/{k}.mp4')
    cache.put(keys[-1], {'feat': (str(srcs / f'{keys[-1]}_feat.npy'), '.npy')})
    survivors = sorted(k for k in keys if cache.contains(k))
    entry = Path(cache.cache_dir) / 'objects'
    truncated, flipped = survivors[0], survivors[1]
    (entry / truncated[:2] / truncated / 'feat.npy').write_bytes(b'short')
    path = entry / flipped[:2] / flipped / 'fps.npy'
    raw = bytearray(path.read_bytes())
    raw[0] ^= 0xFF
    path.write_bytes(bytes(raw))
    served = [cache.fetch_to(k, str(root / 'out2'), f'/v/{k}.mp4')
              for k in survivors]
    stats = cache.stats()
    stats.pop('dir')
    with open(cache.manifest_path, 'a') as f:
        f.write('{"op": "put", "key": "torn')
    reloaded = cls(cache.cache_dir)
    gc_report = reloaded.gc(verify=True)
    return {'stats': stats, 'survivors': survivors, 'served': served,
            'after_gc': sorted(k for k in keys if reloaded.contains(k)),
            'gc': gc_report, 'reloaded': {k: v for k, v in
                                          reloaded.stats().items() if k != 'dir'}}


def test_store_matches_the_jax_store_on_one_sequence(tmp_path):
    ours = _drive_store(store.FeatureCache, tmp_path / 'port')
    theirs = _drive_store(jax_store.FeatureCache, tmp_path / 'jax')
    assert ours == theirs
    st = ours['stats']
    assert st['evictions'] > 0 and st['corrupt_evicted'] == 1
    assert ours['served'][0] is False and ours['gc']['corrupt_evicted'] == 1


def test_a_port_written_store_opens_clean_in_the_jax_store(tmp_path):
    _drive_store(store.FeatureCache, tmp_path)
    port = store.FeatureCache(str(tmp_path / 'store'))
    jax = jax_store.FeatureCache(str(tmp_path / 'store'))
    assert jax.gc(verify=True)['corrupt_evicted'] == 0
    assert jax.stats()['entries'] == port.stats()['entries'] > 0


def test_merge_cache_stats_matches_the_jax_package():
    a = {'entries': 2, 'bytes': 100, 'hits': 3, 'misses': 1, 'puts': 2,
         'peer_hits': 1}
    b = {'entries': 1, 'bytes': 50, 'hits': 0, 'misses': 4, 'evictions': 2,
         'corrupt_evicted': 1, 'bytes_saved': 9, 'l2_publishes': 3}
    assert store.merge_cache_stats([a, b]) == jax_store.merge_cache_stats([a, b])
    assert store.merge_cache_stats([]) == jax_store.merge_cache_stats([])


def test_gc_entry_point_matches_the_jax_tool(tmp_path, capsys):
    """Exit codes 0, 1 and 2 and the report of ``python -m
    video_features_torch.cache.gc`` are those of ``tools/cache_gc.py`` on
    copies of one directory."""
    import tools.cache_gc as jax_gc
    _drive_store(store.FeatureCache, tmp_path)
    dirs = {}
    for side in ('port', 'jax'):
        dirs[side] = tmp_path / side
        shutil.copytree(tmp_path / 'store', dirs[side])
    victim = next((dirs['port'] / 'objects').glob('*/*/feat.npy'))
    for side in dirs:
        (dirs[side] / victim.relative_to(dirs['port'])).write_bytes(b'Z')

    def run(main, side, *extra):
        rc = main(['--cache-dir', str(dirs[side]), *extra])
        out = capsys.readouterr().out.strip()
        rep = json.loads(out) if out else None
        if rep:
            assert rep.pop('cache_dir') == str(dirs[side])
        return rc, rep

    for extra in ((), ('--verify',), ('--target-bytes', '1000'),
                  ('--no-compact', '--verify')):
        assert run(port_gc.main, 'port', *extra) == run(jax_gc.main, 'jax', *extra)
    assert run(port_gc.main, 'port', '--verify')[0] == 0
    for extra in (('--target-bytes', '-1'),):
        assert run(port_gc.main, 'port', *extra)[0] == 2 == \
            run(jax_gc.main, 'jax', *extra)[0]
    assert port_gc.main(['--cache-dir', str(tmp_path / 'nope')]) == 2


def test_gc_reports_a_truncated_entry_with_exit_1(tmp_path, capsys):
    _drive_store(store.FeatureCache, tmp_path)
    root = tmp_path / 'store'
    assert port_gc.main(['--cache-dir', str(root), '--verify']) == 0
    victim = next((root / 'objects').glob('*/*/fps.npy'))
    victim.write_bytes(victim.read_bytes()[:-1])
    assert port_gc.main(['--cache-dir', str(root), '--verify']) == 1
    report = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert report['corrupt_evicted'] == 1 and report['verified'] is True


def _put_one(cache, tmp_path, k, payload=b'x' * 100):
    src = tmp_path / f'{k}.npy'
    src.write_bytes(payload)
    cache.put(k, {'feat': (str(src), '.npy')})


def test_tier_promotes_an_l2_hit_into_l1(tmp_path):
    host_a = TieredFeatureCache(str(tmp_path / 'l1a'), str(tmp_path / 'l2'))
    _put_one(host_a, tmp_path, 'aa1')
    assert host_a.stats()['l2_publishes'] == 1
    host_b = TieredFeatureCache(str(tmp_path / 'l1b'), str(tmp_path / 'l2'))
    assert not store.FeatureCache.contains(host_b, 'aa1')
    assert host_b.fetch_to('aa1', str(tmp_path / 'out'), '/v/clip.mp4')
    assert host_b.stats()['peer_hits'] == 1
    assert store.FeatureCache.contains(host_b, 'aa1')       # promoted
    assert (tmp_path / 'out' / 'clip_feat.npy').read_bytes() == b'x' * 100
    assert host_b.fetch_to('aa1', str(tmp_path / 'out2'), '/v/clip.mp4')
    assert host_b.stats()['peer_hits'] == 1                 # an L1 hit now


def test_tier_evicts_a_corrupt_l2_entry_instead_of_serving_it(tmp_path):
    host_a = TieredFeatureCache(str(tmp_path / 'l1a'), str(tmp_path / 'l2'))
    _put_one(host_a, tmp_path, 'bb2')
    obj = tmp_path / 'l2' / 'objects' / 'bb' / 'bb2' / 'feat.npy'
    obj.write_bytes(b'torn')
    host_b = TieredFeatureCache(str(tmp_path / 'l1b'), str(tmp_path / 'l2'))
    assert not host_b.fetch_to('bb2', str(tmp_path / 'out'), '/v/clip.mp4')
    assert host_b.l2.stats()['corrupt_evicted'] == 1
    assert not host_b.contains('bb2') and host_b.stats()['peer_hits'] == 0
    assert not (tmp_path / 'out' / 'clip_feat.npy').exists()


@pytest.mark.parametrize('bad', [
    dict(cache_enabled=True, cache_dir=None),
    dict(cache_enabled=True, cache_dir='{tmp}/c', cache_max_bytes=-1),
    dict(cache_enabled=True, cache_dir='{tmp}/c', on_extraction='print'),
    dict(cache_l2_dir='{tmp}/l2'),
])
def test_cache_rules_raise_what_the_jax_package_raises(clips, tmp_path, bad):
    from video_features_tpu.config import load_config as jax_load
    bad = {k: v.format(tmp=tmp_path) if isinstance(v, str) else v
           for k, v in bad.items()}
    over = dict(video_paths=clips[0], device='cpu', model_name='resnet18',
                on_extraction='save_numpy', output_path=str(tmp_path / 'o'))
    over.update(bad)
    outcomes = []
    for load in (load_config, jax_load):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter('always')
            try:
                args = load('resnet', overrides=dict(over))
                outcomes.append(('ok', args['cache_enabled'],
                                 [str(w.message) for w in caught
                                  if 'cache' in str(w.message)]))
            except ValueError as e:
                outcomes.append(('ValueError', str(e)))
    assert outcomes[0] == outcomes[1]
    if bad.get('on_extraction') == 'print':
        assert outcomes[0][:2] == ('ok', False) and outcomes[0][2]
    else:
        assert outcomes[0][0] == 'ValueError'


# -- the per-video loop ---------------------------------------------------------


def _count_steps(monkeypatch):
    """Count every dispatched step of every extractor."""
    steps = [0]
    dispatch = BaseExtractor.dispatch

    def counted(self, batch):
        steps[0] += 1
        return dispatch(self, batch)
    monkeypatch.setattr(BaseExtractor, 'dispatch', counted)
    return steps


def test_cli_hit_is_byte_identical_and_runs_no_step(clips, tmp_path, monkeypatch,
                                                    capsys):
    steps = _count_steps(monkeypatch)
    argv = ['feature_type=resnet', 'device=cpu', 'model_name=resnet18',
            'batch_size=4', 'allow_random_weights=true',
            'on_extraction=save_numpy', f'tmp_path={tmp_path}/tmp',
            f'video_paths=[{",".join(clips)}]', 'cache_enabled=true',
            f'cache_dir={tmp_path}/fc']
    assert cli.main(argv + [f'output_path={tmp_path}/cold']) == 0
    cold_steps = steps[0]
    assert cold_steps > 0
    assert cli.main(argv + [f'output_path={tmp_path}/warm']) == 0
    out = capsys.readouterr()
    assert steps[0] == cold_steps
    assert out.out.count('served from cache') == len(clips)
    cold, warm = _npys(tmp_path / 'cold'), _npys(tmp_path / 'warm')
    assert cold == warm and len(cold) == 3 * len(clips)


@pytest.fixture(scope='module')
def resnet_cached(clips, tmp_path_factory):
    """A resnet18 extractor over a cache, after a cold per-video run."""
    root = tmp_path_factory.mktemp('cacheresnet')
    ex = create_extractor(_resnet_args(clips, root / 'cold', cache_enabled=True,
                                       cache_dir=str(root / 'fc')))
    ex.tracer = Tracer()
    ex.print_profile = lambda title: None
    for p in clips:
        assert ex._extract(p) == 'saved'
    return ex, root, _npys(ex.output_path)


def test_per_video_hits_run_no_decode_and_no_step(resnet_cached, clips):
    ex, root, cold = resnet_cached
    assert ex.tracer.report()['cache_publish']['count'] == len(clips)
    ex.tracer.reset()
    ex.output_path = str(root / 'warm')
    assert [ex._extract(p) for p in clips] == ['cached'] * len(clips)
    rep = ex.tracer.report()
    assert set(rep) == {'cache_lookup'} and rep['cache_lookup']['count'] == 2
    assert _npys(ex.output_path) == cold
    # the resume sidecar comes with a hit, so the next run skips
    assert ex._extract(clips[0]) == 'skipped'


def test_cache_disabled_keeps_todays_behaviour(clips, tmp_path):
    ex = create_extractor(_resnet_args(clips, tmp_path / 'out'))
    assert ex.cache is None
    ex.tracer = Tracer()
    ex.print_profile = lambda title: None
    assert [ex._extract(p) for p in clips] == ['saved'] * len(clips)
    rep = ex.tracer.report()
    assert 'cache_lookup' not in rep and 'cache_publish' not in rep
    assert len(_npys(ex.output_path)) == 3 * len(clips)


def test_a_decode_backend_change_re_extracts_with_the_warning(clips, tmp_path,
                                                              capsys):
    from video_features_torch.io import native
    try:
        native.load_library()
    except Exception as e:      # noqa: BLE001 — the host has no libav
        pytest.skip(f'the native decoder does not build here: {e}')
    first = create_extractor(_resnet_args(clips[:1], tmp_path, decode_backend='cv2'))
    assert first._extract(clips[0]) == 'saved'
    assert create_extractor(_resnet_args(
        clips[:1], tmp_path, decode_backend='cv2'))._extract(clips[0]) == 'skipped'
    second = create_extractor(_resnet_args(clips[:1], tmp_path,
                                           decode_backend='native'))
    with pytest.warns(UserWarning, match='different config/checkpoint'):
        assert second._extract(clips[0]) == 'saved'


# -- the packed loop, the farm and fused worklists -----------------------------


def test_packed_worklist_drops_hits_before_batch_planning(resnet_cached, clips,
                                                          tmp_path):
    ex, _, cold = resnet_cached
    ex.tracer.reset()
    tasks = [VideoTask(p, out_root=str(tmp_path)) for p in clips]
    ex.extract_packed(tasks)
    rep = ex.tracer.report()
    assert all(t.cached and t.skipped and t.finalized for t in tasks)
    assert 'model' not in rep and 'h2d' not in rep and 'pack' not in rep, rep
    assert _npys(tmp_path) == cold


def test_packed_run_publishes_and_a_second_packed_run_hits(clips, tmp_path):
    ex = create_extractor(_resnet_args(clips, tmp_path / 'a', cache_enabled=True,
                                       cache_dir=str(tmp_path / 'fc'),
                                       pack_across_videos=True))
    ex.extract_packed([VideoTask(p, out_root=str(tmp_path / 'a')) for p in clips])
    assert ex.cache.stats()['puts'] == len(clips)
    tasks = [VideoTask(p, out_root=str(tmp_path / 'b')) for p in clips]
    ex.extract_packed(tasks)
    assert [t.cached for t in tasks] == [True] * len(clips)
    assert _npys(tmp_path / 'a') == _npys(tmp_path / 'b')


def test_farm_parks_a_duplicate_and_writes_the_per_video_bytes(
        resnet_cached, clips, tmp_path):
    """Two names for one content at decode_workers 2: one decode, the
    duplicate parks until its twin publishes and the cache answers it;
    both outputs are the per-video loop's bytes."""
    _, _, cold = resnet_cached
    twin = tmp_path / 'twin.mp4'
    shutil.copyfile(clips[0], twin)
    paths = [clips[0], str(twin), clips[1]]
    ex = create_extractor(_resnet_args(paths, tmp_path / 'cfg', cache_enabled=True,
                                       cache_dir=str(tmp_path / 'fc'),
                                       pack_across_videos=True, decode_workers=2))
    tasks = [VideoTask(p, out_root=str(tmp_path / 'out')) for p in paths]
    ex.extract_packed(tasks)
    st = ex._farm.stats()
    assert st['ran'] and st['deduped'] == 1 and st['videos_assigned'] == 2
    assert tasks[1].cached and not tasks[0].cached and not tasks[2].cached
    got = _npys(tmp_path / 'out')
    stem = Path(clips[0]).stem
    for k in RESNET_KEYS:
        suffix = f'_{k}.npy'
        assert got['twin' + suffix] == got[stem + suffix] == cold[stem + suffix]
    assert {k: v for k, v in got.items() if not k.startswith('twin')} == cold


def test_fused_run_hashes_each_video_once(tmp_path):
    """resnet18, CLIP ViT-B/32 and timm vit_tiny fused over a cold cache:
    one streaming hash per video for all three families' keys, and a
    second fused run is all hits."""
    paths = [str(write_noise_clip(tmp_path / f'fz{i}.mp4', n, w=64, h=48,
                                  seed=60 + i)) for i, n in enumerate((5, 3))]
    fams = ['resnet', 'clip', 'timm']
    configs = load_fused_configs(fams, {
        'video_paths': paths, 'device': 'cpu', 'allow_random_weights': True,
        'on_extraction': 'save_numpy', 'output_path': str(tmp_path / 'a'),
        'tmp_path': str(tmp_path / 'tmp'), 'batch_size': 4,
        'cache_enabled': True, 'cache_dir': str(tmp_path / 'fc'),
        'resnet.model_name': 'resnet18', 'clip.model_name': 'ViT-B/32',
        'timm.model_name': 'vit_tiny_patch16_224'})
    exs = {fam: create_extractor(args) for fam, args in configs.items()}
    assert len({id(ex.cache) for ex in exs.values()}) == 1
    reset_hash_file_stats()
    assert run_packed_fused(exs, list(paths)) == {'videos': 2, 'decode_passes': 2}
    assert hash_file_stats()['passes'] == len(paths)
    assert exs['resnet'].cache.stats()['puts'] == len(fams) * len(paths)
    before = _npys(tmp_path / 'a')
    for ex in exs.values():
        ex.output_path = ex.output_path.replace(str(tmp_path / 'a'),
                                                str(tmp_path / 'b'))
    assert run_packed_fused(exs, list(paths)) == {'videos': 2, 'decode_passes': 0}
    assert _npys(tmp_path / 'b') == before and len(before) == 3 * 3 * len(paths)
