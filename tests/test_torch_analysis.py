"""vft-lint on the port (``video_features_torch/analysis``): the checker
against the JAX package's, and the port's tree against it.

  * every planted fixture of ``tests/test_analysis.py`` (each JAX test
    that builds one through ``make_pkg`` runs here with a recording
    ``make_pkg``) and the JAX tree itself: the port's analyzer gives the
    JAX analyzer's finding identities ``(rule, file, key)``;
  * the port's own anchors, where the two analyzers differ by design:
    torch in a spawn closure, the port's second knob validator, the
    port's pinned contract sets;
  * the port's tree is clean with the shipped (empty) baseline, and the
    analyzer process imports neither jax nor torch.
"""
import inspect
import json
import subprocess
import sys
import textwrap
import time
from pathlib import Path

import pytest

import tests.test_analysis as jax_tests
from video_features_torch.analysis import (
    Package, analyze, load_baseline, new_findings,
)
from video_features_torch.analysis.__main__ import (
    DEFAULT_BASELINE, main as lint_main,
)
from video_features_torch.analysis.checks import (
    SPAWN_ROOTS, check_contract_keys, check_knob_classification,
    check_spawn_purity, closure_forbidden_imports,
)
from video_features_torch.analysis.imports import spawn_closure
from video_features_tpu.analysis import Package as JaxPackage
from video_features_tpu.analysis import analyze as jax_analyze
from video_features_tpu.analysis.checks import (
    check_knob_classification as jax_check_knob_classification,
    check_spawn_purity as jax_check_spawn_purity,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
PORT_ROOT = REPO_ROOT / 'video_features_torch'

# the probe both analyzer CLIs run under: the module as `python -m`,
# then the heavy roots left in sys.modules on stderr
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


def _fixture_cases():
    """(JAX test name, its parametrize kwargs) for every JAX analyzer test
    that plants a fixture through ``make_pkg``."""
    cases = []
    for name, fn in sorted(vars(jax_tests).items()):
        if not (name.startswith('test_') and inspect.isfunction(fn)
                and 'make_pkg(' in inspect.getsource(fn)):
            continue
        marks = [m for m in getattr(fn, 'pytestmark', [])
                 if m.name == 'parametrize']
        if not marks:
            cases.append(pytest.param(name, {}, id=name))
            continue
        argnames, values = marks[0].args[:2]
        argnames = [a.strip() for a in argnames.split(',')] \
            if isinstance(argnames, str) else list(argnames)
        for i, value in enumerate(values):
            value = value if len(argnames) > 1 else (value,)
            cases.append(pytest.param(name, dict(zip(argnames, value)),
                                      id=f'{name}[{i}]'))
    return cases


FIXTURE_CASES = _fixture_cases()


def identities(findings):
    return sorted(f.identity for f in findings)


def test_every_fixture_test_of_the_jax_suite_is_covered():
    assert len({c.values[0] for c in FIXTURE_CASES}) >= 45


@pytest.mark.parametrize('name,params', FIXTURE_CASES)
def test_fixture_identities_match_the_jax_analyzer(name, params, tmp_path,
                                                   capsys, monkeypatch):
    """The JAX test runs as written; each fixture it plants is analyzed by
    both analyzers the moment it is built."""
    compared = []
    build = jax_tests.make_pkg

    def recording(tmp, files, name='fixpkg', tests=None):
        pkg = build(tmp, files, name=name, tests=tests)
        ours = analyze(Package(pkg.root, pkg.name, tests_dir=pkg.tests_dir))
        compared.append((name, identities(jax_analyze(pkg)),
                         identities(ours)))
        return pkg

    monkeypatch.setattr(jax_tests, 'make_pkg', recording)
    fn = getattr(jax_tests, name)
    wanted = inspect.signature(fn).parameters
    kwargs = dict(params)
    for fixture, value in (('tmp_path', tmp_path), ('capsys', capsys)):
        if fixture in wanted:
            kwargs[fixture] = value
    fn(**kwargs)
    assert compared, f'{name} planted no fixture'
    for pkg_name, theirs, ours in compared:
        assert ours == theirs, pkg_name


def test_jax_tree_identities_match_the_jax_analyzer():
    tests_dir = REPO_ROOT / 'tests'
    theirs = jax_analyze(JaxPackage(REPO_ROOT / 'video_features_tpu',
                                    'video_features_tpu',
                                    tests_dir=tests_dir))
    ours = analyze(Package(REPO_ROOT / 'video_features_tpu',
                           'video_features_tpu', tests_dir=tests_dir))
    assert identities(ours) == identities(theirs)


# -- the port's anchors -----------------------------------------------------

def make_pkg(tmp_path, files, name='fixpkg', tests=None):
    """A fixture package for both analyzers (the JAX suite's layout)."""
    root = tmp_path / name
    root.mkdir(exist_ok=True)
    (root / '__init__.py').write_text('')
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
        if not (p.parent / '__init__.py').exists():
            (p.parent / '__init__.py').write_text('')
    tests_dir = None
    if tests:
        tests_dir = tmp_path / 'tests'
        tests_dir.mkdir(exist_ok=True)
        for fname, src in tests.items():
            (tests_dir / fname).write_text(textwrap.dedent(src))
    return root, tests_dir


def test_spawn_purity_flags_torch_in_a_worker_closure(tmp_path):
    """A spawned decode worker imports no torch (the port's contract):
    the port's rule flags it, the JAX rule (jax and flax only) does not."""
    root, _ = make_pkg(tmp_path, {
        'farm/worker.py': '''
            def worker_main():
                from fixpkg.io.video import load
        ''',
        'io/video.py': '''
            import torch

            def load():
                return None
        ''',
    })
    findings = check_spawn_purity(Package(root, 'fixpkg'))
    assert [(f.file, f.key) for f in findings] == [('io/video.py',
                                                    'import:torch')]
    assert jax_check_spawn_purity(JaxPackage(root, 'fixpkg')) == []


def test_knob_validated_by_check_common_keys_or_a_helper(tmp_path):
    """The port validates knobs in ``check_common_keys`` and in the
    ``check_*_keys`` helpers the validators call: each counts."""
    root, _ = make_pkg(tmp_path, {'config.py': '''
        KNOB_CLASSIFICATION = {'a_knob': 'neither', 'b_knob': 'neither',
                               'c_knob': 'neither'}

        FOO_DEFAULTS = {'a_knob': 1, 'b_knob': 2, 'c_knob': 3}

        def check_cache_keys(args):
            args['b_knob'] = int(args['b_knob'])

        def check_common_keys(args):
            args['a_knob'] = int(args['a_knob'])

        def sanity_check(args):
            check_cache_keys(args)
    '''})
    assert {f.key for f in check_knob_classification(
        Package(root, 'fixpkg'))} == {'unvalidated:c_knob'}
    assert {f.key for f in jax_check_knob_classification(
        JaxPackage(root, 'fixpkg'))} == {'unvalidated:a_knob',
                                         'unvalidated:b_knob',
                                         'unvalidated:c_knob'}


def test_contract_sets_come_from_the_port_tests_first(tmp_path):
    """``test_torch_obs.py`` pins the port's sets; a set it does not pin
    is read from ``test_obs.py``."""
    manifest = '''
        def document():
            return {'a': 1}
    '''
    root, tests_dir = make_pkg(tmp_path, {'obs/manifest.py': manifest},
                               tests={'test_torch_obs.py': "MANIFEST_KEYS = {'a'}\n",
                                      'test_obs.py': "MANIFEST_KEYS = {'b'}\n"})
    assert check_contract_keys(Package(root, 'fixpkg', tests_dir)) == []
    (tests_dir / 'test_torch_obs.py').write_text('OTHER = {1}\n')
    keys = {f.key for f in check_contract_keys(
        Package(root, 'fixpkg', tests_dir))}
    assert keys == {'run manifest document:unpinned:a',
                    'run manifest document:stale:b'}


def loaded() -> frozenset:
    """The heavy roots this test process holds already: a host embedding
    the CLI passes them (the module-level default is the state when the
    CLI module was imported, which depends on the test order)."""
    return frozenset(m for m in ('jax', 'torch') if m in sys.modules)


def test_cli_exit_codes_on_fixtures(tmp_path, capsys):
    make_pkg(tmp_path, {'a.py': 'x = 1\n'}, name='clean')
    make_pkg(tmp_path, {'a.py': 'print("boom")\n'}, name='dirty')
    base = ['--baseline', str(tmp_path / 'b.json')]

    def lint(*args):
        return lint_main(list(args) + base, preloaded=loaded())
    assert lint('--root', str(tmp_path / 'clean'), '--package-name',
                'clean') == 0
    assert lint('--root', str(tmp_path / 'dirty'), '--package-name',
                'dirty') == 2
    assert 'stdout-purity' in capsys.readouterr().out
    assert lint('--root', str(tmp_path / 'dirty'), '--package-name',
                'dirty', '--write-baseline') == 0
    assert lint('--root', str(tmp_path / 'dirty'), '--package-name',
                'dirty', '--fail-on-new') == 0
    assert lint('--rules', 'no-such-rule') == 1


def test_cli_exit_3_when_torch_appears_during_the_run(tmp_path):
    """The analyzer's own purity guard: torch loaded during the run (here
    it was loaded before, and ``preloaded`` says it was not) is exit 3."""
    import torch  # noqa: F401
    make_pkg(tmp_path, {'a.py': 'x = 1\n'}, name='clean')
    args = ['--root', str(tmp_path / 'clean'), '--package-name', 'clean',
            '--baseline', str(tmp_path / 'b.json')]
    assert lint_main(args, preloaded=loaded() - {'torch'}) == 3
    assert lint_main(args, preloaded=loaded()) == 0


# -- the port's tree ---------------------------------------------------------

def test_port_tree_is_clean_against_the_shipped_empty_baseline():
    assert json.loads(DEFAULT_BASELINE.read_text()) == []
    pkg = Package(PORT_ROOT, 'video_features_torch',
                  tests_dir=REPO_ROOT / 'tests')
    fresh = new_findings(analyze(pkg), load_baseline(DEFAULT_BASELINE))
    assert fresh == [], '\n'.join(f.render() for f in fresh)


def test_entry_chain_is_jax_and_torch_free():
    pkg = Package(PORT_ROOT, 'video_features_torch')
    assert closure_forbidden_imports(pkg, ('__init__.py',), 'analyzer-purity',
                                     'analyzer entry') == []


def test_spawn_closure_covers_the_farm_surface():
    closure = spawn_closure(Package(PORT_ROOT, 'video_features_torch'),
                            SPAWN_ROOTS)
    assert {'farm/worker.py', 'farm/recipes.py', 'ops/host_transforms.py',
            'farm/ring.py', 'io/video.py',
            'extract/streaming.py'} <= set(closure)


def run_probe(module: str):
    t0 = time.monotonic()
    proc = subprocess.run(
        [sys.executable, '-c', PROBE.replace('MODULE', repr(module))],
        capture_output=True, text=True, cwd=str(REPO_ROOT), timeout=120)
    heavy = [line.split('=', 1)[1] for line in proc.stderr.splitlines()
             if line.startswith('heavy=')]
    return proc, heavy, time.monotonic() - t0


def test_analyzer_subprocess_imports_neither_jax_nor_torch():
    proc, heavy, wall = run_probe('video_features_torch.analysis')
    assert proc.returncode == 0, (proc.stdout, proc.stderr)
    assert heavy == [''], heavy
    assert wall < 30, f'vft-lint took {wall:.1f} s'
