"""The port's executable store (video_features_torch/aot/, fleet/artifacts.py)
held to the JAX package's on the CPU.

  * the store and the two-tier store against the JAX package's
    (torch-free ``video_features_tpu/aot/store.py`` and
    ``fleet/artifacts.py``) on one operation sequence: equal ``stats()``,
    gc reports and replayed indexes; ``exec_digest`` and
    ``merge_exec_stats`` on the same inputs;
  * ``python -m video_features_torch aot-gc`` against ``tools/aot_gc.py``
    on copies of one store;
  * ``ensure_library`` with a toolchain that builds a tiny C library with
    ``cc -shared`` (a stand-in for nvcc, which this host lacks): cold
    compile and publish, a second process that loads with no build, a
    same-size corrupt payload evicted before it is ever loaded, the drift
    event, the fleet tier's pull;
  * the ``aot_*`` config rules against the JAX package's messages;
  * a resnet18 run with ``aot_enabled`` byte-equal to one without (no
    hand kernel on its path: the store stays empty), and the manifest's
    and the daemon's ``aot`` keys against the JAX package's.
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

from video_features_torch.aot import runtime
from video_features_torch.aot.store import ExecStore, exec_digest, merge_exec_stats

REPO = Path(__file__).resolve().parent.parent
CC = shutil.which('cc') or shutil.which('gcc')
needs_cc = pytest.mark.skipif(CC is None, reason='no C compiler (cc or gcc) on '
                              'this host to build the stand-in library')

C_SOURCE = 'int vft_answer(int x) { return 3 * x + 1; }\n'


# -- the store against the JAX package's ---------------------------------------


def _digest(name):
    return exec_digest({'program_sha': name, 'lane': 'sm_90a'})


def _replay(store_cls, aot_dir):
    """A fresh instance's index, without the recency stamps."""
    fresh = store_cls(aot_dir)
    return {d: (e['size'], e['sha256'], e['meta']) for d, e in fresh._index.items()}


def _store_sequence(store_cls, root):
    """put, fetch, idempotent put (a touch), truncation, evict_corrupt,
    gc with verify and a target, and a put another instance appends while
    the gc sweeps; returns what each step reported."""
    store = store_cls(str(root / 'store'))
    out = []
    for i in range(5):
        store.put(_digest(f'p{i}'), bytes([i]) * (100 + 10 * i),
                  meta={'program_sha': f'p{i}', 'program': f'lib{i}'})
    out.append(store.fetch(_digest('p0')))
    store.put(_digest('p1'), b'ignored')                # a touch
    out.append(store.fetch(_digest('missing')))
    victim = Path(store._payload_path(_digest('p2')))
    victim.write_bytes(victim.read_bytes()[:7])          # truncated
    out.append(store.fetch(_digest('p2')))
    store.evict_corrupt(_digest('p3'))
    rot = Path(store._payload_path(_digest('p4')))
    rot.write_bytes(b'\xff' * rot.stat().st_size)        # same-size bit rot
    real_load = store._load_manifest
    raced = []

    def load_then_race():
        real_load()
        if not raced:
            raced.append(1)
            store_cls(store.aot_dir).put(_digest('late'), b'l' * 50)
    store._load_manifest = load_then_race
    out.append(store.gc(target_bytes=10_000, verify=True))
    del store._load_manifest
    store.put(_digest('p5'), b'5' * 150)
    out.append(store.gc(target_bytes=300))
    stats = store.stats()
    stats.pop('dir')
    out.append(stats)
    out.append(_replay(store_cls, store.aot_dir))
    return out


def test_store_matches_the_jax_store_on_one_sequence(tmp_path):
    from video_features_tpu.aot import store as jax_store
    port = _store_sequence(ExecStore, tmp_path / 'port')
    jax = _store_sequence(jax_store.ExecStore, tmp_path / 'jax')
    assert port == jax
    assert port[-2]['corrupt_evicted'] == 3 and port[-2]['evictions'] >= 1
    assert _digest('late') in port[-1]           # the racing put survived
    comps = [{'program_sha': 'a', 'lane': 'sm_90a', 'capability': [9, 0]},
             {'lane': 'x', 'program_sha': 'b', 'devices': [0, 1]}]
    assert [exec_digest(c) for c in comps] == [jax_store.exec_digest(c)
                                               for c in comps]
    stats = [{'entries': 2, 'bytes': 10, 'hits': 3, 'misses': 1, 'puts': 2,
              'evictions': 0, 'corrupt_evicted': 1},
             {'entries': 1, 'bytes': 5, 'hits': 0, 'misses': 4, 'puts': 1,
              'pulled': 2, 'published': 1, 'l2': {'hits': 9}}]
    assert merge_exec_stats(stats) == jax_store.merge_exec_stats(stats)
    assert merge_exec_stats(()) == jax_store.merge_exec_stats(())


def _tier_sequence(tier_cls, root):
    """Publish through one host's tier, pull on a second host's empty L1,
    evict a corrupt entry from both tiers; returns both hosts' stats."""
    l2 = str(root / 'l2')
    a = tier_cls(str(root / 'a'), l2)
    a.put(_digest('x'), b'x' * 64, meta={'program_sha': 'x'})
    a.put(_digest('y'), b'y' * 32, meta={'program_sha': 'y'})
    b = tier_cls(str(root / 'b'), l2)
    got = [b.fetch(_digest('x')), b.fetch(_digest('x')), b.fetch(_digest('z')),
           b.metas_for('y'), b.contains(_digest('y'))]
    b.evict_corrupt(_digest('x'))
    got.append(a.l2.contains(_digest('x')))
    out = []
    for host in (a, b):
        st = host.stats()
        for doc in (st, st['l2']):
            doc.pop('dir')
        out.append(st)
    return got, out


def test_tiered_store_matches_the_jax_tier(tmp_path, monkeypatch):
    from video_features_tpu.aot.store import ExecStore as JaxStore
    from video_features_tpu.fleet import artifacts as jax_artifacts
    from video_features_torch.fleet import artifacts
    # fresh process-wide registries, so neither side shares an L2 instance
    monkeypatch.setattr(ExecStore, '_instances', {})
    monkeypatch.setattr(JaxStore, '_instances', {})
    port = _tier_sequence(artifacts.TieredExecStore, tmp_path / 'port')
    jax = _tier_sequence(jax_artifacts.TieredExecStore, tmp_path / 'jax')
    assert port == jax
    got, (_, b) = port
    assert got[0] == got[1] == b'x' * 64 and got[2] is None
    assert b['pulled'] == 1 and got[-1] is False
    merged = merge_exec_stats([b])
    assert (merged['pulled'], merged['published']) == (1, 0)


def test_aot_gc_gives_the_tools_exit_codes_and_report(tmp_path, capsys):
    sys.path.insert(0, str(REPO))
    from tools.aot_gc import main as jax_gc
    from video_features_torch.cli import main as cli
    store = ExecStore(str(tmp_path / 'store'))
    store.put(_digest('good'), b'g' * 256)
    store.put(_digest('bad'), b'b' * 256)
    store.put(_digest('old'), b'o' * 128)
    Path(store._payload_path(_digest('bad'))).write_bytes(b'B' * 256)
    dirs = {name: shutil.copytree(store.aot_dir, tmp_path / name)
            for name in ('port', 'jax')}
    runs = [['--no-compact'], [], ['--verify'], ['--verify'],
            ['--target-bytes', '200'], ['--target-bytes', '-1']]
    results = {}
    for name, main in (('port', lambda a: cli(['aot-gc', *a])), ('jax', jax_gc)):
        results[name] = []
        for extra in runs:
            code = main(['--aot-dir', str(dirs[name]), *extra])
            out = capsys.readouterr().out.strip()
            report = json.loads(out) if out else None
            if report is not None:
                assert report.pop('aot_dir') == str(dirs[name])
            results[name].append((code, report))
        results[name].append((main(['--aot-dir', str(tmp_path / 'nope')]),
                              capsys.readouterr().out))
    assert results['port'] == results['jax']
    assert [code for code, _ in results['port']] == [0, 0, 1, 0, 0, 2, 2]
    assert results['port'][2][1]['corrupt_evicted'] == 1
    assert results['port'][4][1]['lru_evicted'] == 1
    proc = subprocess.run(
        [sys.executable, '-c', 'import sys\n'
         f'sys.path.insert(0, {str(REPO)!r})\n'
         'from video_features_torch.cli import main\n'
         f'rc = main(["aot-gc", "--aot-dir", {str(dirs["port"])!r}, "--verify"])\n'
         'print("torch" in sys.modules, "jax" in sys.modules, rc)'],
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip().splitlines()[-1] == 'False False 0'


# -- ensure_library with a C compiler in nvcc's place -------------------------


class CcToolchain:
    """``ops/_kernels.py``'s three functions over a tiny C source built
    with ``cc -shared``; ``builds`` counts the compiler runs, and
    ``forbid_build`` makes a build fail the test."""

    def __init__(self, src_dir, build_dir, forbid_build=False):
        self.src = Path(src_dir) / 'answer.c'
        self.build_dir = Path(build_dir)
        self.forbid_build = forbid_build
        self.builds = 0

    def library_identity(self, name):
        source = hashlib.sha256(self.src.read_bytes()).hexdigest()
        return {'library': name, 'source_sha256': source, 'flags': '-shared',
                'nvcc': 'cc', 'program_sha': hashlib.sha256(
                    f'{source}|-shared|cc'.encode()).hexdigest()}

    def library_path(self, name, identity=None):
        identity = identity or self.library_identity(name)
        return self.build_dir / f'lib{name}-{identity["program_sha"][:12]}.so'

    def build(self, name):
        if self.forbid_build:
            raise AssertionError('the library was built')
        out = self.library_path(name)
        if out.exists():
            return out, ''
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([CC, '-shared', '-fPIC', '-O1', '-o', str(out),
                        str(self.src)], check=True, capture_output=True)
        self.builds += 1
        return out, 'built'


@pytest.fixture
def toolchain(tmp_path):
    (tmp_path / 'src').mkdir()
    (tmp_path / 'src' / 'answer.c').write_text(C_SOURCE)
    return CcToolchain(tmp_path / 'src', tmp_path / 'build0')


@pytest.fixture
def loads(monkeypatch):
    """The bytes of every file ``ensure_library`` hands to ``dlopen``."""
    seen = []
    real = runtime.ctypes.CDLL

    def cdll(path, *a, **kw):
        seen.append(Path(path).read_bytes())
        return real(path, *a, **kw)
    monkeypatch.setattr(runtime.ctypes, 'CDLL', cdll)
    return seen


LOAD_IN_A_FRESH_PROCESS = r'''
import json, sys
sys.path.insert(0, {repo!r})
from tests.test_torch_aot import CcToolchain
from video_features_torch.aot import runtime
from video_features_torch.aot.store import ExecStore
tc = CcToolchain({src!r}, {build!r}, forbid_build=True)
lib, path = runtime.ensure_library(ExecStore({store!r}), 'answer', lane='host',
                                   feature_type='toy', toolchain=tc)
print(json.dumps([path, lib.vft_answer(14)]))
'''


@needs_cc
def test_ensure_library_compiles_publishes_then_loads_elsewhere(tmp_path, toolchain):
    store = ExecStore(str(tmp_path / 'store'))
    lib, path = runtime.ensure_library(store, 'answer', lane='host',
                                       feature_type='toy', toolchain=toolchain)
    assert (path, lib.vft_answer(14), toolchain.builds) == ('compiled', 43, 1)
    assert store.stats()['puts'] == 1 and store.stats()['entries'] == 1
    (meta,) = store.metas_for(toolchain.library_identity('answer')['program_sha'])
    assert meta['program'] == 'answer' and meta['lane'] == 'host'
    assert set(runtime.DRIFT_KEYS) <= set(meta)
    proc = subprocess.run([sys.executable, '-c', LOAD_IN_A_FRESH_PROCESS.format(
        repo=str(REPO), src=str(tmp_path / 'src'), build=str(tmp_path / 'fresh'),
        store=store.aot_dir)], capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == ['loaded', 43]
    built = toolchain.library_path('answer')
    loaded = CcToolchain(tmp_path / 'src', tmp_path / 'fresh').library_path('answer')
    assert loaded.read_bytes() == built.read_bytes()


@needs_cc
def test_a_corrupt_payload_is_evicted_and_never_loaded(tmp_path, toolchain, loads):
    store = ExecStore(str(tmp_path / 'store'))
    runtime.ensure_library(store, 'answer', lane='host', toolchain=toolchain)
    (digest,) = store._index
    payload = Path(store._payload_path(digest))
    good = payload.read_bytes()
    bad = bytearray(good)
    for i in range(64, len(bad), 97):
        bad[i] ^= 0xFF                      # flipped bytes at the same size
    payload.write_bytes(bytes(bad))
    fresh = ExecStore(store.aot_dir)
    tc = CcToolchain(tmp_path / 'src', tmp_path / 'fresh')
    lib, path = runtime.ensure_library(fresh, 'answer', lane='host', toolchain=tc)
    assert (path, tc.builds, lib.vft_answer(2)) == ('compiled', 1, 7)
    st = fresh.stats()
    assert (st['corrupt_evicted'], st['hits'], st['misses']) == (1, 0, 1)
    assert bytes(bad) not in loads
    assert not tc.library_path('answer').read_bytes() == bytes(bad)
    assert Path(fresh._payload_path(digest)).read_bytes() == tc.library_path(
        'answer').read_bytes()              # rebuilt and published again
    from video_features_torch.obs.events import events_tail
    (warn,) = [e for e in events_tail(20)
               if e['msg'].startswith('stored executable failed its sha256')]
    assert warn['level'] == 'WARNING' and warn['subsystem'] == 'aot'


def _move_entry(store_dir, digest, **meta_changes):
    """Rewrite one entry as if another environment had published it: its
    meta changed and its key rehashed from the changed components."""
    store = ExecStore(store_dir)
    entry = store._index[digest]
    meta = dict(entry['meta'], **meta_changes)
    components = {k: v for k, v in meta.items()
                  if k not in ('feature_type', 'program')}
    new = exec_digest(components)
    os.makedirs(os.path.dirname(store._entry_dir(new)), exist_ok=True)
    os.replace(store._entry_dir(digest), store._entry_dir(new))
    Path(store.manifest_path).write_text(json.dumps(
        {'op': 'put', 'key': new, 'size': entry['size'],
         'sha256': entry['sha256'], 'meta': meta, 't': 1.0}) + '\n')
    return new


@needs_cc
def test_a_drifted_environment_is_named_and_rebuilt(tmp_path, toolchain):
    store = ExecStore(str(tmp_path / 'store'))
    runtime.ensure_library(store, 'answer', lane='host', toolchain=toolchain)
    (digest,) = store._index
    _move_entry(store.aot_dir, digest, device_kind='NVIDIA A100-SXM4-80GB')
    from video_features_torch.obs.events import events_tail
    fresh = ExecStore(store.aot_dir)
    tc = CcToolchain(tmp_path / 'src', tmp_path / 'fresh')
    _, path = runtime.ensure_library(fresh, 'answer', lane='host', toolchain=tc)
    assert path == 'compiled' and fresh.stats()['entries'] == 2
    (drift,) = [e for e in events_tail(20)
                if e['msg'].startswith('executable present under a different')]
    assert 'device_kind' in drift['fields']['drift']
    assert 'NVIDIA A100-SXM4-80GB' in drift['fields']['drift']
    assert 'torch' not in drift['fields']['drift']


@needs_cc
def test_the_fleet_tier_pulls_and_evicts_by_the_recorded_sha(tmp_path, toolchain,
                                                              loads, monkeypatch):
    from video_features_torch.fleet.artifacts import TieredExecStore
    monkeypatch.setattr(ExecStore, '_instances', {})
    a = TieredExecStore(str(tmp_path / 'a'), str(tmp_path / 'l2'))
    runtime.ensure_library(a, 'answer', lane='host', toolchain=toolchain)
    assert (a.stats()['puts'], a.stats()['published'],
            a.l2.stats()['puts']) == (1, 1, 1)
    # a fresh host: its L1 is empty, the library comes from the shared tier
    b = TieredExecStore(str(tmp_path / 'b'), str(tmp_path / 'l2'))
    tc = CcToolchain(tmp_path / 'src', tmp_path / 'b_build', forbid_build=True)
    lib, path = runtime.ensure_library(b, 'answer', lane='host', toolchain=tc)
    assert (path, lib.vft_answer(1), b.stats()['pulled']) == ('loaded', 4, 1)
    # flipped bytes in b's L1 copy: evicted from L1 alone, pulled again
    (digest,) = b._index
    l1 = Path(b._payload_path(digest))
    good = l1.read_bytes()
    l1.write_bytes(good[:100] + bytes(255 - c for c in good[100:200]) + good[200:])
    bad = l1.read_bytes()
    tc = CcToolchain(tmp_path / 'src', tmp_path / 'b_build2', forbid_build=True)
    _, path = runtime.ensure_library(b, 'answer', lane='host', toolchain=tc)
    st = b.stats()
    assert (path, st['pulled'], st['corrupt_evicted']) == ('loaded', 2, 1)
    assert b.l2.contains(digest) and bad not in loads
    # flipped bytes in the shared copy: a pull that fails is evicted there
    # and never reaches a third host's L1
    l2 = Path(b.l2._payload_path(digest))
    l2.write_bytes(bytes(255 - c for c in l2.read_bytes()))
    c = TieredExecStore(str(tmp_path / 'c'), str(tmp_path / 'l2'))
    tc = CcToolchain(tmp_path / 'src', tmp_path / 'c_build')
    _, path = runtime.ensure_library(c, 'answer', lane='host', toolchain=tc)
    assert (path, tc.builds, c.stats()['pulled']) == ('compiled', 1, 0)
    assert c.l2.stats()['corrupt_evicted'] == 1
    assert c.l2.fetch(digest) == tc.library_path('answer').read_bytes()


# -- config and the end to end run ---------------------------------------------


AOT_INPUTS = [
    {'aot_enabled': True, 'aot_dir': None},
    {'aot_enabled': True, 'aot_dir': ''},
    {'aot_enabled': True, 'aot_dir': 5},
    {'aot_max_bytes': -5},
    {'aot_max_bytes': '7'},
    {'aot_l2_dir': '/shared/l2'},
    {'aot_enabled': True, 'aot_l2_dir': 3},
]


@pytest.mark.parametrize('inputs', AOT_INPUTS, ids=lambda d: ','.join(
    f'{k}={v}' for k, v in d.items()))
def test_aot_config_rules_match_the_jax_package(tmp_path, inputs):
    from tools.make_sample_video import write_noise_clip
    from video_features_torch.config import load_config
    from video_features_tpu.config import load_config as jax_load_config
    clip = write_noise_clip(tmp_path / 'v.mp4', 3)
    results = []
    for load in (load_config, jax_load_config):
        try:
            args = load('resnet', overrides={
                'video_paths': [clip], 'device': 'cpu',
                'output_path': str(tmp_path / 'o'), **inputs})
            results.append({k: args[k] for k in inputs})
        except ValueError as e:
            results.append(str(e))
    assert results[0] == results[1]


def test_resnet18_with_the_store_is_byte_equal_and_keys_match_jax(tmp_path,
                                                                 monkeypatch):
    """No hand kernel lies on resnet18's path: the store stays empty, both
    runs write the same bytes, and the manifest's ``aot`` section and the
    daemon's ``aot`` keys are the JAX package's."""
    import torch

    from video_features_torch.ops import _kernels
    # the store configure_aot attaches to the loader is process-wide
    monkeypatch.setattr(_kernels, '_store', None)
    monkeypatch.setattr(_kernels, '_build_dir', None)

    from tools.make_sample_video import write_noise_clip
    from video_features_torch.config import load_config
    from video_features_torch.registry import create_extractor
    from video_features_tpu.extract.base import BaseExtractor as JaxBase
    from video_features_tpu.serve import metrics as jax_metrics
    from video_features_tpu.aot import store as jax_store
    from video_features_tpu.obs.metrics import MetricsRegistry as JaxRegistry
    from video_features_torch.obs.metrics import MetricsRegistry
    from video_features_torch.serve import metrics
    clip = write_noise_clip(tmp_path / 'v.mp4', 3, seed=5)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    outs = {}
    try:
        for name, extra in (('off', {}), ('on', {
                'aot_enabled': True, 'aot_dir': str(tmp_path / 'aot'),
                'manifest_out': str(tmp_path / 'm.json')})):
            args = load_config('resnet', overrides={
                'video_paths': [clip], 'device': 'cpu', 'model_name': 'resnet18',
                'batch_size': 2, 'allow_random_weights': True,
                'on_extraction': 'save_numpy',
                'output_path': str(tmp_path / name), **extra})
            ex = create_extractor(args)
            ex._extract(clip)
            ex.finish_obs()
            outs[name] = {p.name: p.read_bytes()
                          for p in sorted((tmp_path / name).rglob('*.npy'))}
    finally:
        torch.set_num_threads(threads)
    assert outs['on'] == outs['off'] and len(outs['on']) == 3
    assert ex.aot_warm() == {'loaded': 0, 'compiled': 0}
    store = ex._aot_store
    assert store.stats()['entries'] == 0 and store.stats()['misses'] == 0
    section = json.loads((tmp_path / 'm.json').read_text())['aot']
    jax_like = types.SimpleNamespace(_aot_store=types.SimpleNamespace(
        aot_dir='d'), aot_stats={'loaded': 0, 'compiled': 0}, _aot_programs={})
    assert set(section) == set(JaxBase.aot_snapshot(jax_like))
    assert (section['enabled'], section['loaded'], section['compiled'],
            section['programs']) == (True, 0, 0, {})
    docs = {}
    for name, mod, merge, registry, st in (
            ('port', metrics, merge_exec_stats, MetricsRegistry, store.stats()),
            ('jax', jax_metrics, jax_store.merge_exec_stats, JaxRegistry,
             jax_store.ExecStore(str(tmp_path / 'jax_aot')).stats())):
        aot = merge([st])
        aot.update(programs_loaded=0, programs_compiled=0)
        reg = registry()
        doc = mod.build_metrics(0.0, 0, 64, False, {'size': 0}, mod.RequestStats(reg),
                                {}, aot_stats=aot)
        docs[name] = (doc['aot'], sorted(
            line.split()[2] for line in mod.prometheus_text(doc, reg).splitlines()
            if line.startswith('# TYPE vft_aot_')))
    assert set(docs['port'][0]) == set(docs['jax'][0])
    assert docs['port'][1] == docs['jax'][1] and docs['port'][1]


@needs_cc
@pytest.mark.parametrize('stored', [False, True])
def test_an_extractor_reaches_its_libraries_through_the_loader(
        tmp_path, toolchain, monkeypatch, stored):
    """``configure_aot`` attaches the store to ``ops/_kernels.py::load``;
    the first step reaches each library of ``kernel_libraries`` once,
    ``aot_stats`` and ``aot_snapshot`` say how (compiled on a cold store,
    loaded from a published one), and a second step reaches nothing."""
    from video_features_torch.extract.base import BaseExtractor
    from video_features_torch.ops import _kernels

    class Toy(BaseExtractor):
        def kernel_libraries(self):
            return ('answer',)

        def packed_step(self, batch):
            lib = _kernels.load('answer')
            return {'x': batch * 0 + lib.vft_answer(int(batch.sum()))}

    for name in ('library_identity', 'library_path', 'build'):
        monkeypatch.setattr(_kernels, name, getattr(toolchain, name))
    monkeypatch.setattr(_kernels, '_resident', {})
    monkeypatch.setattr(_kernels, '_store', None)
    _kernels.load.cache_clear()
    store_dir = str(tmp_path / 'aot')
    if stored:        # another process built and published it
        runtime.ensure_library(ExecStore(store_dir), 'answer', lane='sm_90a',
                               toolchain=CcToolchain(tmp_path / 'src',
                                                     tmp_path / 'other'))
    monkeypatch.setattr(ExecStore, '_instances', {})
    try:
        ex = Toy({'feature_type': 'toy', 'output_path': str(tmp_path / 'o'),
                  'device': 'cpu'})
        ex.configure_aot({'aot_enabled': True, 'aot_dir': store_dir})
        out = ex.run_step(np.ones((2, 3), np.float32))
        ex.run_step(np.ones((2, 3), np.float32))
        path = 'loaded' if stored else 'compiled'
        assert (out['x'] == 19).all()
        assert ex.aot_stats == {'loaded': int(stored), 'compiled': int(not stored)}
        assert toolchain.builds == int(not stored)
        snap = ex.aot_snapshot()
        (key, prog), = snap['programs'].items()
        sha = toolchain.library_identity('answer')['program_sha']
        assert key == f'answer@{sha[:12]}' and prog['path'] == path
        assert prog['identity']['source_sha256'] == hashlib.sha256(
            C_SOURCE.encode()).hexdigest()
        assert ex._aot_store.stats()['entries'] == 1
        assert _kernels.resident('answer')['path'] == path
        assert ex.aot_warm() == {'loaded': 0, 'compiled': 0}
    finally:
        _kernels.load.cache_clear()
