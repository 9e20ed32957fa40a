"""vft-wire on the port (``video_features_torch/analysis/wire.py``): the
checker against the JAX package's, and the port's wire against the
shared ``WIRE.lock.json``.

  * every planted wire fixture of ``tests/test_wire.py`` (each JAX test
    that builds one through ``make_wire_pkg`` runs here with a recording
    ``make_wire_pkg``): the port's checker extracts the same surface and
    reports the JAX checker's finding identities;
  * the port's tree: its surface is the JAX tree's, clean against the
    repo-root lock, which the port never writes; the checker's process
    imports neither jax nor torch.
"""
import inspect
import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

import tests.test_wire as jax_tests
from video_features_torch.analysis import wire
from video_features_torch.analysis.core import Package
from video_features_tpu.analysis import wire as jax_wire
from video_features_tpu.analysis.core import Package as JaxPackage

REPO_ROOT = Path(__file__).resolve().parent.parent
SHARED_LOCK = REPO_ROOT / 'WIRE.lock.json'

PROBE = '''
import runpy, sys
sys.argv = [MODULE]
rc = 0
try:
    runpy.run_module(MODULE, run_name='__main__')
except SystemExit as e:
    rc = e.code or 0
print('heavy=' + ','.join(m for m in ('jax', 'torch') if m in sys.modules),
      file=sys.stderr)
sys.exit(rc)
'''

WIRE_CASES = [pytest.param(name, id=name)
              for name, fn in sorted(vars(jax_tests).items())
              if name.startswith('test_') and inspect.isfunction(fn)
              and 'make_wire_pkg(' in inspect.getsource(fn)]


def identities(findings):
    return sorted(f.identity for f in findings)


def test_every_wire_fixture_test_is_covered():
    assert len(WIRE_CASES) >= 20


@pytest.mark.parametrize('name', WIRE_CASES)
def test_fixture_surface_and_identities_match_the_jax_checker(
        name, tmp_path, capsys, monkeypatch):
    compared = []
    build = jax_tests.make_wire_pkg

    def recording(tmp, mutate=None, name='fixwire', docs=True):
        pkg, docs_dir = build(tmp, mutate, name=name, docs=docs)
        theirs_surface, theirs = jax_wire.run(pkg, docs_dir)
        ours_surface, ours = wire.run(Package(pkg.root, pkg.name), docs_dir)
        compared.append((name, jax_wire.lock_view(theirs_surface),
                         wire.lock_view(ours_surface), identities(theirs),
                         identities(ours)))
        return pkg, docs_dir

    monkeypatch.setattr(jax_tests, 'make_wire_pkg', recording)
    fn = getattr(jax_tests, name)
    wanted = inspect.signature(fn).parameters
    kwargs = {k: v for k, v in (('tmp_path', tmp_path), ('capsys', capsys))
              if k in wanted}
    fn(**kwargs)
    assert compared, f'{name} planted no wire fixture'
    for pkg_name, theirs_view, ours_view, theirs, ours in compared:
        assert ours_view == theirs_view, pkg_name
        assert ours == theirs, pkg_name


def test_port_surface_is_the_jax_surface():
    ours = wire.extract_surface(Package(REPO_ROOT / 'video_features_torch',
                                        'video_features_torch'))
    theirs = jax_wire.extract_surface(JaxPackage(
        REPO_ROOT / 'video_features_tpu', 'video_features_tpu'))
    assert wire.lock_view(ours) == jax_wire.lock_view(theirs)


def test_port_wire_is_clean_against_the_shared_lock(capsys):
    assert wire.default_lock_path() == SHARED_LOCK
    assert wire.main([]) == 0
    assert 'vs lock v' in capsys.readouterr().err


def test_the_shared_lock_is_read_only(tmp_path, capsys):
    before = SHARED_LOCK.read_bytes()
    assert wire.main(['--write-lock']) == 1
    assert 'read-only' in capsys.readouterr().err
    with pytest.raises(ValueError, match='never writes'):
        wire.write_lock(SHARED_LOCK, {'version': 'x'})
    assert SHARED_LOCK.read_bytes() == before
    # another path takes a re-pin: the port's surface pins the shared
    # lock's document
    other = tmp_path / 'wire.json'
    assert wire.main(['--write-lock', '--lock', str(other)]) == 0
    assert json.loads(other.read_text()) == json.loads(before)
    assert wire.main(['--lock', str(other)]) == 0


def test_drift_against_another_lock_is_reported(tmp_path):
    lock = json.loads(SHARED_LOCK.read_text())
    lock['commands'].pop(sorted(lock['commands'])[0])
    other = tmp_path / 'wire.json'
    other.write_text(json.dumps(lock))
    assert wire.main(['--lock', str(other)]) == 2


def test_checker_subprocess_imports_neither_jax_nor_torch():
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, '-c',
         PROBE.replace('MODULE', repr('video_features_torch.analysis.wire'))],
        capture_output=True, text=True, cwd=str(REPO_ROOT), timeout=120)
    wall = time.monotonic() - t0
    heavy = [line.split('=', 1)[1] for line in proc.stderr.splitlines()
             if line.startswith('heavy=')]
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert heavy == [''], heavy
    assert wall < 30, f'vft-wire took {wall:.1f} s'
