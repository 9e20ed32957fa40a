"""The port's feature index (video_features_torch/index/) held to the JAX
package's (video_features_tpu/index/) on the CPU, on seeded numpy inputs:

  * the store: one operation script on both stores gives byte-identical
    trees, and a tree written by either loads in the other;
  * ingest: ``fold_manifest`` over a cache the port's resnet18 run filled
    (plus a torn tail, a shrunk manifest and the entries that are not
    frame-wise) gives identical index trees;
  * queries: 13 queries, k = 7 and k above the live rows, tombstoned and
    padded rows, two keys with identical vectors: the same hits in the
    same order, scores within 1e-6;
  * the offline tools: the ``index`` CLI's report and the GC's report and
    exit codes;
  * the served index: an ``ExtractionServer`` with ``index_enabled``
    against the JAX daemon on one seeded resnet18 checkpoint (search by
    vector and by video, ``index_status``, metrics, prewarm, eviction,
    the gateway's ``POST /v1/search``).
"""
import json
import os
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from tools.make_sample_video import write_noise_clip
from video_features_torch.index import search as port_search
from video_features_torch.index import service as port_service
from video_features_torch.index.shards import IndexStore as PortStore

DIM = 8
# report keys that name a place or a time, not a result
VOLATILE = ('wall_s', 'dir', 'index_dir', 'manifest_out')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax():
    from video_features_tpu.index import search, service, shards
    return shards.IndexStore, search, service


def _rows(n, dim=DIM, seed=0):
    return np.random.default_rng(seed).standard_normal((n, dim)).astype(
        np.float32)


def _metas(n, key, t0=0):
    return [{'video': f'{key}.mp4', 'video_sha256': f'sha-{key}',
             't_ms': t0 + 1000 * i, 'key': key} for i in range(n)]


def _tree(root):
    root = Path(root)
    return {str(p.relative_to(root)): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


def _strip(doc):
    if isinstance(doc, dict):
        return {k: _strip(v) for k, v in doc.items() if k not in VOLATILE}
    if isinstance(doc, list):
        return [_strip(v) for v in doc]
    return doc


def _script(store):
    """One operation sequence over every write path of the store; yields
    after each operation so the trees are compared step by step."""
    store.add_rows('resnet', _rows(7, seed=1), _metas(7, 'k1'))
    yield 'add'
    store.add_rows('resnet', _rows(5, seed=2), _metas(5, 'k2', t0=40))
    store.add_rows('clip', _rows(3, dim=4, seed=3), _metas(3, 'c1'))
    store.add_rows('resnet', _rows(2, dim=4, seed=4), _metas(2, 'k9'))
    yield 'add two families and two dims'
    store.add_rows('resnet', _rows(7, seed=1), _metas(7, 'k1'))
    yield 're-add a live key'
    store.drop_key('k1')
    store.drop_key('nope')
    yield 'drop'
    store.set_cursor('cache_manifest', 1234)
    yield 'cursor'
    store.compact()
    yield 'compact'
    store.add_rows('resnet', _rows(4, seed=5), _metas(4, 'k3'))
    store.orphan_sweep(lambda key: key != 'k2')
    yield 'orphan sweep'
    store.compact()
    store.add_rows('clip', _rows(1, dim=4, seed=6), _metas(1, 'c2'))
    yield 'compact and add'


@pytest.mark.parametrize('shard_rows', [1, 3, 4, 1024])
def test_one_operation_script_writes_the_jax_stores_bytes(tmp_path,
                                                          shard_rows):
    JaxStore, _, _ = _jax()
    stores = (JaxStore(str(tmp_path / 'jax'), shard_rows=shard_rows),
              PortStore(str(tmp_path / 'port'), shard_rows=shard_rows))
    for step, _ in zip(_script(stores[0]), _script(stores[1])):
        assert _tree(tmp_path / 'jax') == _tree(tmp_path / 'port'), step
    assert _strip(stores[0].stats()) == _strip(stores[1].stats())


def _views(store):
    out = []
    for family in store.families():
        for gkey in sorted(g for g in store._groups if g[0] == family):
            out.append([(a.tolist(), m.tolist(), metas)
                        for a, m, metas in store.shard_views(gkey)])
    return out


@pytest.mark.parametrize('writer', ['jax', 'port'])
def test_a_tree_written_by_either_store_loads_in_the_other(tmp_path, writer):
    """Including a torn tail, a foreign line and a row past its shard
    file's end (a crashed publish)."""
    JaxStore, _, _ = _jax()
    cls = {'jax': JaxStore, 'port': PortStore}
    store = cls[writer](str(tmp_path / 'idx'), shard_rows=3)
    for _ in _script(store):
        pass
    with open(store.manifest_path, 'ab') as f:
        f.write(b'{"op": "nonsense"}\n')
        f.write(json.dumps({'op': 'add', 'family': 'clip', 'dim': 4,
                            'shard': 0, 'row': 99, 'key': 'ghost'}
                           ).encode() + b'\n')
        f.write(b'{"op": "add", "family": "re')
    loaded = {name: c(str(tmp_path / 'idx'), shard_rows=3)
              for name, c in cls.items()}
    assert _strip(loaded['jax'].stats()) == _strip(loaded['port'].stats())
    assert _views(loaded['jax']) == _views(loaded['port'])
    assert loaded['port'].cursor('cache_manifest') == 1234
    assert sorted(loaded['port'].keys()) == sorted(loaded['jax'].keys())


def test_add_rows_grows_a_shard_once_per_call(tmp_path):
    """The port builds each touched shard with one concatenation (the JAX
    store concatenates once per row): the same rows, the same file."""
    calls = []
    real = np.concatenate

    def counting(arrays, *a, **k):
        calls.append(len(arrays))
        return real(arrays, *a, **k)
    store = PortStore(str(tmp_path / 'p'), shard_rows=1024)
    np_mod = __import__('video_features_torch.index.shards',
                        fromlist=['np']).np
    try:
        np_mod.concatenate = counting
        store.add_rows('resnet', _rows(300), _metas(300, 'big'))
    finally:
        np_mod.concatenate = real
    # one call of 301 arrays (the empty shard and the 300 rows), not 300
    # calls of two; numpy's own calls may add a few
    assert calls.count(301) == 1 and len(calls) < 5
    JaxStore, _, _ = _jax()
    JaxStore(str(tmp_path / 'j'), shard_rows=1024).add_rows(
        'resnet', _rows(300), _metas(300, 'big'))
    assert _tree(tmp_path / 'p') == _tree(tmp_path / 'j')


# -- ingest --------------------------------------------------------------------


@pytest.fixture(scope='module')
def filled_cache(tmp_path_factory):
    """A cache directory the port's resnet18 run filled on the CPU, plus
    three entries that are not frame-wise pairs: i3d's ``rgb``/``flow``,
    r21d without timestamps and raft's 4-D flow."""
    from video_features_torch.cache.store import FeatureCache
    from video_features_torch.config import load_config
    from video_features_torch.registry import create_extractor
    root = tmp_path_factory.mktemp('filled')
    clips = [str(write_noise_clip(root / f'ix{i}.mp4', n, seed=20 + i))
             for i, n in enumerate((5, 3))]
    cache_dir = root / 'cache'
    args = load_config('resnet', {
        'device': 'cpu', 'model_name': 'resnet18', 'batch_size': 4,
        'allow_random_weights': True, 'on_extraction': 'save_numpy',
        'video_paths': clips, 'output_path': str(root / 'out'),
        'tmp_path': str(root / 'tmp'), 'cache_enabled': True,
        'cache_dir': str(cache_dir)})
    ex = create_extractor(args)
    for clip in clips:
        ex._extract(clip)
    cache = FeatureCache(str(cache_dir))
    src = root / 'src'
    src.mkdir()
    shapes = {'rgb': (3, 16), 'flow': (3, 16), 'r21d': (2, 16),
              'raft': (2, 2, 4, 4), 'fps': (), 'timestamps_ms': (2,)}
    for name, shape in shapes.items():
        np.save(src / f'{name}.npy',
                np.arange(int(np.prod(shape)), dtype=np.float32).reshape(shape))

    def files(*names):
        return {n: (str(src / f'{n}.npy'), '.npy') for n in names}
    cache.put('i3d-entry', files('rgb', 'flow', 'fps', 'timestamps_ms'),
              meta={'feature_type': 'i3d', 'video': 'a.mp4'})
    cache.put('r21d-entry', files('r21d'),
              meta={'feature_type': 'r21d', 'video': 'a.mp4'})
    cache.put('raft-entry', files('raft', 'fps', 'timestamps_ms'),
              meta={'feature_type': 'raft', 'video': 'a.mp4'})
    return cache_dir, clips


def _copy_cache(src, dst):
    import shutil
    shutil.copytree(src, dst)
    return str(dst)


def _fold_both(tmp_path, cache_dir):
    from video_features_tpu.cache.store import FeatureCache as JaxCache
    from video_features_torch.cache.store import FeatureCache
    JaxStore, _, jax_service = _jax()
    reports = {}
    for name, store_cls, cache_cls, svc in (
            ('jax', JaxStore, JaxCache, jax_service),
            ('port', PortStore, FeatureCache, port_service)):
        store = store_cls(str(tmp_path / f'idx_{name}'), shard_rows=4)
        reports[name] = svc.fold_manifest(store, cache_cls(cache_dir))
    assert _tree(tmp_path / 'idx_jax') == _tree(tmp_path / 'idx_port')
    assert reports['jax'] == reports['port']
    return reports['port']


def test_ingest_of_a_port_filled_cache_gives_the_jax_tree(filled_cache,
                                                          tmp_path):
    cache_dir = _copy_cache(filled_cache[0], tmp_path / 'cache')
    rep = _fold_both(tmp_path, cache_dir)
    # two resnet18 clips of 5 and 3 frames; i3d, r21d and raft skipped
    assert rep['rows_added'] == 8 and rep['objects_skipped'] == 3
    store = PortStore(str(tmp_path / 'idx_port'), shard_rows=4)
    assert store.stats()['families'] == {
        'resnet': {'dims': [512], 'rows_live': 8, 'shards': 2}}
    # a second pass folds nothing
    assert _fold_both(tmp_path, cache_dir)['bytes_folded'] == 0


def test_ingest_waits_out_a_torn_tail_as_the_jax_fold_does(filled_cache,
                                                          tmp_path):
    cache_dir = _copy_cache(filled_cache[0], tmp_path / 'cache')
    manifest = Path(cache_dir) / 'manifest.jsonl'
    whole = manifest.read_bytes()
    with open(manifest, 'ab') as f:
        f.write(b'{"op": "put", "key": "half", "fi')
    _fold_both(tmp_path, cache_dir)
    store = PortStore(str(tmp_path / 'idx_port'), shard_rows=4)
    assert store.cursor(port_service.CURSOR_SOURCE) == len(whole)


def test_ingest_replays_a_shrunk_manifest_as_the_jax_fold_does(filled_cache,
                                                              tmp_path):
    """An eviction, then the cache GC's compaction shrinks the manifest
    under the cursor: both folds replay from zero, drop the evicted
    key's rows and add nothing twice."""
    from video_features_torch.cache.store import FeatureCache
    cache_dir = _copy_cache(filled_cache[0], tmp_path / 'cache')
    _fold_both(tmp_path, cache_dir)
    cache = FeatureCache(cache_dir)
    store = PortStore(str(tmp_path / 'idx_port'), shard_rows=4)
    victim = sorted(store.keys())[0]
    with cache._lock:
        cache._evict_locked(victim)
    cache.gc(compact=True)
    assert os.path.getsize(cache.manifest_path) < store.cursor(
        port_service.CURSOR_SOURCE)
    rep = _fold_both(tmp_path, cache_dir)
    assert rep['rows_added'] == 0


# -- queries ---------------------------------------------------------------------


def _query_stores(tmp_path):
    """Both stores over one seeded script: 40 rows in shards of 16 (the
    last one padded), 10 tombstoned, and two keys with identical rows."""
    JaxStore, _, _ = _jax()
    base = _rows(30, dim=32, seed=7)
    stores = {}
    for name, cls in (('jax', JaxStore), ('port', PortStore)):
        s = cls(str(tmp_path / name), shard_rows=16)
        s.add_rows('resnet', base[:10], _metas(10, 'dead'))
        s.add_rows('resnet', base[10:25], _metas(15, 'live'))
        s.add_rows('resnet', base[25:], _metas(5, 'twin_a'))
        s.add_rows('resnet', base[25:], _metas(5, 'twin_b'))
        s.add_rows('resnet', _rows(5, dim=32, seed=8), _metas(5, 'tail'))
        s.drop_key('dead')
        stores[name] = s
    return stores


def _ident(hits):
    return [[(h['key'], h['t_ms'], h['video'], h['family']) for h in lst]
            for lst in hits]


@pytest.mark.parametrize('k', [7, 64])
def test_queries_return_the_jax_hits_in_order(tmp_path, k):
    _, jax_search, _ = _jax()
    stores = _query_stores(tmp_path)
    rng = np.random.default_rng(9)
    queries = rng.standard_normal((13, 32)).astype(np.float32)
    # two queries are exact rows: one tombstoned, one with a twin
    queries[3] = _rows(30, dim=32, seed=7)[2]
    queries[11] = _rows(30, dim=32, seed=7)[27]
    jax_engine = jax_search.QueryEngine(stores['jax'], aot_store=None,
                                        query_block=8, k_max=64)
    port_engine = port_search.QueryEngine(stores['port'], device='cpu',
                                          query_block=8, k_max=64)
    jax_hits, _ = jax_engine.search('resnet', queries, k)
    port_hits, _ = port_engine.search('resnet', queries, k)
    assert _ident(port_hits) == _ident(jax_hits)
    for pl, jl in zip(port_hits, jax_hits):
        np.testing.assert_allclose([h['score'] for h in pl],
                                   [h['score'] for h in jl], atol=1e-6)
    live = 30
    assert [len(lst) for lst in port_hits] == [min(k, live)] * 13
    # the tombstoned row is never a hit; the twins tie and keep row order
    assert all(h['key'] != 'dead' for lst in port_hits for h in lst)
    top2 = [h['key'] for h in port_hits[11][:2]]
    assert top2 == ['twin_a', 'twin_b']
    assert port_hits[11][0]['score'] == port_hits[11][1]['score']
    assert port_engine.queries_total == 13
    assert (port_engine.programs_loaded, port_engine.programs_compiled) == (0, 0)
    merged = port_search.QueryEngine.merge_hits(port_hits, k)
    assert _ident([merged]) == _ident(
        [jax_search.QueryEngine.merge_hits(jax_hits, k)])


def test_topk_keeps_lax_top_k_order_on_ties():
    """Equal scores: the lower row first, as ``lax.top_k`` returns them,
    in fp32 with TF32 off, and the flags restored."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    shard = torch.zeros(6, 4)
    shard[[1, 3, 4], 0] = 1.0
    shard[5, 1] = 1.0
    q = torch.tensor([[1.0, 0.0, 0.0, 0.0]])
    mask = torch.tensor([1.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    values, rows = port_search.topk(shard, q, mask, 4)
    assert rows.tolist() == [[1, 4, 0, 2]]
    assert values.dtype == torch.float32
    assert values[0, :2].tolist() == [1.0, 1.0]
    assert (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32) == flags


@pytest.mark.parametrize('bad', ['unknown_family', 'wrong_dim', 'empty'])
def test_query_errors_are_the_jax_errors(tmp_path, bad):
    _, jax_search, _ = _jax()
    stores = _query_stores(tmp_path)
    family, queries = {'unknown_family': ('nope', np.ones(32)),
                       'wrong_dim': ('resnet', np.ones(5)),
                       'empty': ('resnet', np.ones((0, 32)))}[bad]
    errors = []
    for engine in (jax_search.QueryEngine(stores['jax'], aot_store=None),
                   port_search.QueryEngine(stores['port'], device='cpu')):
        with pytest.raises(ValueError) as e:
            engine.search(family, queries, 5)
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_the_engine_runs_on_cuda_unless_told_otherwise(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    with pytest.raises(RuntimeError, match='device=cpu'):
        port_search.QueryEngine(PortStore(str(tmp_path / 'i')))


# -- the config rules ---------------------------------------------------------

INDEX_CASES = {
    'enabled_without_cache': {'index_enabled': True},
    'enabled_with_cache': {'index_enabled': True, 'cache_enabled': True},
    'shard_rows_0': {'index_shard_rows': 0},
    'query_block_0': {'index_query_block': 0},
    'k_max_0': {'index_k_max': 0},
    'poll_0': {'index_poll_s': 0},
    'strings': {'index_dir': 7, 'index_k_max': '12', 'index_poll_s': '2'},
}


@pytest.mark.parametrize('case', sorted(INDEX_CASES))
def test_index_config_rules_equal_the_jax_packages(tmp_path, case):
    from video_features_tpu.config import load_config as jax_load
    from video_features_torch.config import load_config
    clip = str(write_noise_clip(tmp_path / 'c.mp4', 3, seed=1))
    base = {'device': 'cpu', 'model_name': 'resnet18', 'video_paths': clip,
            'output_path': str(tmp_path / 'o'), 'tmp_path': str(tmp_path / 't'),
            'cache_dir': str(tmp_path / 'cache'), 'on_extraction': 'save_numpy',
            **INDEX_CASES[case]}
    out = {}
    for name, load in (('jax', jax_load), ('port', load_config)):
        try:
            args = load('resnet', dict(base))
            out[name] = {k: args[k] for k in args if k.startswith('index_')}
        except ValueError as e:
            out[name] = str(e)
    assert out['port'] == out['jax']


# -- the offline tools ---------------------------------------------------------


def _cli_pair(capsys, argv_jax, argv_port):
    from video_features_tpu.index.cli import index_main as jax_main
    from video_features_torch.index.cli import index_main
    out = {}
    for name, fn, argv in (('jax', jax_main, argv_jax),
                           ('port', index_main, argv_port)):
        rc = fn(argv)
        lines = capsys.readouterr().out.strip().splitlines()
        assert len(lines) == 1
        out[name] = (rc, _strip(json.loads(lines[0])))
    return out


@pytest.mark.parametrize('case', ['ingest_query_status', 'compact_manifest',
                                  'bad_family', 'no_family'])
def test_index_cli_reports_equal_the_jax_clis(filled_cache, tmp_path, capsys,
                                              case):
    cache = {n: _copy_cache(filled_cache[0], tmp_path / f'cache_{n}')
             for n in ('jax', 'port')}
    q = tmp_path / 'q.npy'
    np.save(q, np.random.default_rng(3).standard_normal((3, 512)).astype(
        np.float32))
    tail = {'ingest_query_status': ['--ingest', '--query', str(q), '--k', '4',
                                    '--status'],
            'compact_manifest': ['--ingest', '--compact', '--manifest-out',
                                 str(tmp_path / '{}.json')],
            'bad_family': ['--ingest', '--query', str(q), '--family', 'nosuch'],
            'no_family': ['--query', str(q)]}[case]

    def argv(name):
        return ['--cache-dir', cache[name], '--shard-rows', '4',
                *[a.format(name) for a in tail]]
    out = _cli_pair(capsys, argv('jax'), argv('port') + ['--device', 'cpu'])
    hits = {n: o[1].get('query', {}).pop('hits', []) for n, o in out.items()}
    assert out['port'] == out['jax']
    assert _ident([hits['port']]) == _ident([hits['jax']])
    np.testing.assert_allclose([h['score'] for h in hits['port']],
                               [h['score'] for h in hits['jax']], atol=1e-6)
    if case == 'ingest_query_status':
        assert out['port'][0] == 0 and len(hits['port']) == 4
    if case == 'compact_manifest':
        man = json.loads((tmp_path / 'port.json').read_text())
        jax_man = json.loads((tmp_path / 'jax.json').read_text())
        assert _strip(man['index']) == _strip(jax_man['index'])
        assert man['index']['rows_live'] == 8
    if case in ('bad_family', 'no_family'):
        assert out['port'][0] == 1 and out['port'][1]['ok'] is False


def test_index_cli_query_without_a_gpu_names_device(filled_cache, tmp_path):
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    from video_features_torch.index.cli import index_main
    q = tmp_path / 'q.npy'
    np.save(q, np.ones(512, np.float32))
    with pytest.raises(RuntimeError, match='device=cpu'):
        index_main(['--cache-dir', str(tmp_path), '--query', str(q)])


def test_index_gc_reports_and_exit_codes_equal_the_jax_tools(tmp_path,
                                                             capsys):
    import tools.index_gc as jax_gc
    from video_features_torch.index import gc as port_gc
    JaxStore, _, _ = _jax()

    def run(fn, *args):
        rc = fn(list(args))
        out = capsys.readouterr().out.strip()
        return rc, _strip(json.loads(out)) if out else None
    for tool in (jax_gc.main, port_gc.main):
        assert run(tool, '--cache-dir', str(tmp_path / 'nope'))[0] == 2
    results = {}
    for name, tool, cls in (('jax', jax_gc.main, JaxStore),
                            ('port', port_gc.main, PortStore)):
        cache_dir = tmp_path / f'cache_{name}'
        cache_dir.mkdir()
        store = cls(str(cache_dir / 'index'), shard_rows=4)
        store.add_rows('resnet', _rows(5, seed=60), _metas(5, 'orphaned'))
        results[name] = [run(tool, '--cache-dir', str(cache_dir),
                             '--orphan-sweep'),
                         run(tool, '--cache-dir', str(cache_dir),
                             '--orphan-sweep', '--no-compact')]
    assert results['port'] == results['jax']
    assert [r[0] for r in results['port']] == [1, 0]
    assert results['port'][0][1]['orphans_dropped'] == 5


def test_index_gc_runs_as_a_module(tmp_path):
    import subprocess
    import sys
    proc = subprocess.run(
        [sys.executable, '-m', 'video_features_torch.index.gc', '--cache-dir',
         str(tmp_path)], capture_output=True, text=True, timeout=120,
        cwd=str(Path(__file__).resolve().parents[1]))
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout)['orphans_dropped'] == 0


# -- the served index --------------------------------------------------------------


@pytest.fixture(scope='module')
def served(tmp_path_factory):
    """The JAX daemon and the port's, each with ``index_enabled`` over its
    own cache, on one seeded resnet18 checkpoint, each having extracted
    the same two clips; a gateway in front of the port's."""
    from video_features_tpu.serve.server import ExtractionServer as JaxServer
    from video_features_torch.ingress.auth import ApiKeyAuth, Tenant
    from video_features_torch.ingress.gateway import IngressGateway
    from video_features_torch.models import resnet
    from video_features_torch.serve.server import ExtractionServer
    root = tmp_path_factory.mktemp('served')
    ckpt = root / 'resnet18.pt'
    torch.save({k: torch.from_numpy(v) for k, v in
                resnet.init_state_dict(seed=0, arch='resnet18').items()}, ckpt)
    clips = [str(write_noise_clip(root / f'sx{i}.mp4', n, seed=40 + i))
             for i, n in enumerate((6, 4))]
    servers = {}
    for name, cls in (('jax', JaxServer), ('port', ExtractionServer)):
        base = {'device': 'cpu', 'model_name': 'resnet18', 'batch_size': 4,
                'checkpoint_path': str(ckpt), 'on_extraction': 'save_numpy',
                'tmp_path': str(root / name / 'tmp'), 'cache_enabled': True,
                'cache_dir': str(root / name / 'cache'), 'index_enabled': True,
                'index_shard_rows': 4, 'index_poll_s': 0.05,
                'trace_out': str(root / name / 'trace.json')}
        servers[name] = cls(base_overrides=base, queue_depth=16,
                            pool_size=2).start()
    gateway = IngressGateway(servers['port'], auth=ApiKeyAuth(
        {'k1': Tenant('acme')})).start()
    for name, server in servers.items():
        out = server.submit('resnet', clips, overrides={
            'output_path': str(root / name / 'out')})
        assert out['ok'], out
        _wait(server, out['request_id'])
        _wait_ingested(server, 10)
    yield servers, gateway, clips, root
    gateway.begin_drain()
    gateway.finish_drain()
    for server in servers.values():
        server.drain(wait=True, grace_s=60)


def _wait(server, rid, timeout_s=240):
    deadline = time.monotonic() + timeout_s
    while True:
        st = server.status(rid)
        if st.get('state') != 'running':
            assert st.get('state') == 'done', st
            return st
        assert time.monotonic() < deadline, st
        time.sleep(0.05)


def _wait_ingested(server, rows, timeout_s=60):
    deadline = time.monotonic() + timeout_s
    while True:
        st = server.index_service.stats()
        if st['rows_live'] >= rows and st['ingest_lag_bytes'] == 0:
            return st
        assert time.monotonic() < deadline, st
        time.sleep(0.05)


def _same_ranking(got, ref, atol=1e-5, gap=1e-4):
    """Hits agree by (video, t_ms) wherever neighbouring scores differ by
    more than ``gap``, every score within ``atol``."""
    assert len(got) == len(ref)
    np.testing.assert_allclose([h['score'] for h in got],
                               [h['score'] for h in ref], atol=atol)
    scores = [h['score'] for h in ref]
    for i, (g, r) in enumerate(zip(got, ref)):
        near = any(abs(scores[i] - scores[j]) <= gap
                   for j in (i - 1, i + 1) if 0 <= j < len(scores))
        if not near:
            assert (g['video'], g['t_ms']) == (r['video'], r['t_ms']), i


def test_served_search_by_vector_and_by_video_equal_the_jax_daemons(served):
    servers, _, clips, root = served
    from video_features_torch.utils.output import load_numpy, make_path
    vec = load_numpy(make_path(str(root / 'port' / 'out' / 'resnet' /
                                   'resnet18'), clips[0], 'resnet', '.npy'))[2]
    got = {n: s._dispatch({'cmd': 'search', 'family': 'resnet',
                           'vector': vec.tolist(), 'k': 6})
           for n, s in servers.items()}
    assert got['port']['ok'] and got['jax']['ok']
    _same_ranking(got['port']['hits'], got['jax']['hits'])
    assert got['port']['hits'][0]['t_ms'] == got['jax']['hits'][0]['t_ms']
    assert got['port']['hits'][0]['score'] == pytest.approx(1.0, abs=1e-5)
    by_video = {n: s._dispatch({'cmd': 'search', 'video_path': clips[1],
                                'features': ['resnet'], 'k': 5})
                for n, s in servers.items()}
    assert by_video['port']['ok'], by_video['port']
    assert by_video['port']['video_sha256'] == by_video['jax']['video_sha256']
    _same_ranking(by_video['port']['results']['resnet'],
                  by_video['jax']['results']['resnet'])
    # every window of the queried video finds itself first
    top = by_video['port']['results']['resnet'][0]
    assert top['video'] == Path(clips[1]).name and top['score'] == pytest.approx(1.0,
                                                                       abs=1e-5)
    errs = {n: s._dispatch({'cmd': 'search', 'family': 'resnet',
                            'vector': [1.0, 2.0], 'k': 3})
            for n, s in servers.items()}
    assert errs['port'] == errs['jax']
    assert errs['port']['ok'] is False and 'query dim' in errs['port']['error']


def test_served_status_metrics_and_prewarm_equal_the_jax_daemons(served):
    servers, _, _, _ = served
    status = {n: s._dispatch({'cmd': 'index_status'})['index']
              for n, s in servers.items()}
    assert set(status['port']) == set(status['jax'])
    for key in ('enabled', 'rows_live', 'rows_dead', 'shards', 'rows_indexed',
                'ingest_lag_bytes', 'objects_skipped', 'ingest_errors',
                'programs_loaded', 'programs_compiled'):
        assert status['port'][key] == status['jax'][key], key
    assert status['port']['families'] == status['jax']['families']
    docs = {n: s.metrics() for n, s in servers.items()}
    assert set(docs['port']['index']) == set(docs['jax']['index'])
    proms = {n: s._prometheus(docs[n]) for n, s in servers.items()}
    fams = {n: sorted(set(l.split()[2] for l in t.splitlines()
                          if l.startswith('# TYPE vft_index_')))
            for n, t in proms.items()}
    assert fams['port'] == fams['jax'] and len(fams['port']) >= 5
    # the ingest and query spans land on one persistent recorder
    for server in servers.values():
        assert server._dispatch({'cmd': 'search', 'family': 'resnet',
                                 'vector': [1.0] * 512, 'k': 2})['ok']
    names = {n: sorted({e['name'] for e in s.index_service._recorder.snapshot()
                        if e.get('ph') == 'X'})
             for n, s in servers.items()}
    assert names['port'] == names['jax'] == ['index_ingest', 'index_query']
    reports = {n: s.prewarm(['index']) for n, s in servers.items()}
    assert reports['port'] == reports['jax'] == {
        'entries': 1, 'programs_loaded': 0, 'programs_compiled': 0,
        'errors': []}


def test_an_evicted_key_is_never_a_served_hit(served):
    servers, _, clips, root = served
    from video_features_torch.utils.output import load_numpy, make_path
    vec = load_numpy(make_path(str(root / 'port' / 'out' / 'resnet' /
                                   'resnet18'), clips[1], 'resnet', '.npy'))[0]
    out = {}
    for name, server in servers.items():
        svc = server.index_service
        key = next(k for k in svc.store.keys() if _meta(svc.store, k)[
            'video'] == Path(clips[1]).name)
        with svc.cache._lock:
            svc.cache._evict_locked(key)
        svc.cache._notify_evictions()
        hits = server._dispatch({'cmd': 'search', 'family': 'resnet',
                                 'vector': vec.tolist(), 'k': 10})['hits']
        assert all(h['key'] != key for h in hits)
        assert all(h['video'] != Path(clips[1]).name for h in hits)
        out[name] = [(h['video'], h['t_ms']) for h in hits]
    assert out['port'] == out['jax']


def _meta(store, key):
    gkey, shard_i, row_j = store._rows_by_key[key][0]
    return store._groups[gkey].metas[shard_i][row_j]


def _http(port, method, path, body=None, key='k1'):
    import http.client
    c = http.client.HTTPConnection('127.0.0.1', port, timeout=120)
    headers = {'Authorization': f'Bearer {key}'} if key else {}
    c.request(method, path, body=json.dumps(body) if body is not None
              else None, headers=headers)
    r = c.getresponse()
    doc = json.loads(r.read())
    c.close()
    return r.status, doc


def test_gateway_search_answers_200_and_503_index_disabled(served, tmp_path):
    from video_features_torch.ingress.auth import ApiKeyAuth, Tenant
    from video_features_torch.ingress.gateway import IngressGateway
    from video_features_torch.serve.server import ExtractionServer
    servers, gateway, clips, _ = served
    vec = np.random.default_rng(1).standard_normal(512).tolist()
    st, doc = _http(gateway.port, 'POST', '/v1/search',
                    {'family': 'resnet', 'vector': vec, 'k': 3})
    assert st == 200 and doc['ok'] and doc['tenant'] == 'acme', doc
    direct = servers['port']._dispatch({'cmd': 'search', 'family': 'resnet',
                                        'vector': vec, 'k': 3})
    assert [(h['key'], h['t_ms']) for h in doc['hits']] == \
        [(h['key'], h['t_ms']) for h in direct['hits']]
    st, doc = _http(gateway.port, 'POST', '/v1/search',
                    {'family': 'resnet', 'vector': [1.0], 'k': 3})
    assert st == 400 and doc['error'] == 'search_failed'
    plain = ExtractionServer(base_overrides={'device': 'cpu'}).start()
    off = IngressGateway(plain, auth=ApiKeyAuth({'k1': Tenant('acme')})).start()
    try:
        st, doc = _http(off.port, 'POST', '/v1/search',
                        {'family': 'resnet', 'vector': vec})
        assert st == 503 and doc['error'] == 'index_disabled', doc
        assert plain._dispatch({'cmd': 'index_status'}) == {
            'ok': True, 'index': {'enabled': False}}
        refused = plain._dispatch({'cmd': 'search', 'family': 'resnet',
                                   'vector': vec})
        assert refused['code'] == 'unsupported'
        assert refused['error'].startswith('index is not enabled')
    finally:
        off.begin_drain()
        off.finish_drain()
        plain.drain(wait=True, grace_s=30)


def test_the_ingest_worker_keeps_a_watchdog_row_as_the_jax_one(tmp_path):
    """With ``watchdog_stall_s`` the ingest thread advances its own row,
    ``index-ingest``, with the stage ``index_ingest``; the drain forgets
    it."""
    from video_features_tpu.serve.server import ExtractionServer as JaxServer
    from video_features_torch.serve.server import ExtractionServer
    rows = {}
    for name, cls in (('jax', JaxServer), ('port', ExtractionServer)):
        server = cls(base_overrides={
            'device': 'cpu', 'cache_enabled': True, 'watchdog_stall_s': 30,
            'cache_dir': str(tmp_path / name / 'cache'),
            'index_enabled': True, 'index_poll_s': 0.05}).start()
        try:
            deadline = time.monotonic() + 30
            while port_service.INGEST_WORKER not in \
                    server.watchdog.snapshot()['workers']:
                assert time.monotonic() < deadline
                time.sleep(0.02)
            row = server.watchdog.snapshot()['workers'][
                port_service.INGEST_WORKER]
            rows[name] = (row['stage'], row['pending'], row['stalled'])
        finally:
            server.drain(wait=True, grace_s=30)
        assert port_service.INGEST_WORKER not in \
            server.watchdog.snapshot()['workers']
    assert rows['port'] == rows['jax'] == ('index_ingest', 0, False)
