"""The port imports neither jax, the JAX package, nor pip timm."""
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT_SOURCES = sorted((REPO / 'video_features_torch').rglob('*.py')) + [
    REPO / 'chip_smoke.py']
FORBIDDEN = ('jax', 'jaxlib', 'video_features_tpu', 'timm')
# the vggish slice's modules, the decoders' binding, the streaming
# loop's and the packed loop's modules, the decode farm's, the precision
# lanes' and the feature cache's, by name
REQUIRED = tuple(f'video_features_torch.{m}' for m in (
    'io.native', 'io.audio', 'ops.audio', 'models.vggish', 'extract.vggish',
    'parallel', 'parallel.packing', 'extract.streaming', 'utils.tracing',
    'farm', 'farm.farm', 'farm.ring', 'farm.recipes', 'farm.worker',
    'ops.precision', 'ops.quant', 'cache', 'cache.key', 'cache.store',
    'cache.gc', 'fleet', 'fleet.tier'))

IMPORT_ALL = r'''
import importlib, pkgutil, sys
import video_features_torch
for mod in pkgutil.walk_packages(video_features_torch.__path__,
                                 'video_features_torch.'):
    importlib.import_module(mod.name)
import chip_smoke
bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)
missing = [m for m in %r if m not in sys.modules]
print(len([m for m in sys.modules if m.startswith('video_features_torch')]))
assert not bad, bad
assert not missing, missing
''' % (FORBIDDEN, REQUIRED)


def test_importing_every_port_module_pulls_no_jax():
    proc = subprocess.run([sys.executable, '-c', IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.split()[-1]) >= 60     # every module was imported


def test_port_sources_import_no_jax():
    pattern = re.compile(
        r'^\s*(?:import|from)\s+(%s)\b' % '|'.join(FORBIDDEN), re.MULTILINE)
    offenders = [str(p.relative_to(REPO)) for p in PORT_SOURCES
                 if pattern.search(p.read_text())]
    assert offenders == []
