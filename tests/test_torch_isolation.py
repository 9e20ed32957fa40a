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
# lanes', the feature cache's, the mesh and multihost layer's, and the
# serve daemon's and the HF re-keying's, by name
REQUIRED = tuple(f'video_features_torch.{m}' for m in (
    'io.native', 'io.audio', 'ops.audio', 'models.vggish', 'extract.vggish',
    'parallel', 'parallel.packing', 'extract.streaming', 'utils.tracing',
    'farm', 'farm.farm', 'farm.ring', 'farm.recipes', 'farm.worker',
    'ops.precision', 'ops.quant', 'cache', 'cache.key', 'cache.store',
    'cache.gc', 'fleet', 'fleet.tier', 'obs', 'obs.events', 'obs.context',
    'obs.spans', 'obs.metrics', 'obs.manifest', 'obs.blackbox',
    'parallel.mesh', 'parallel.distributed', 'parallel.worklist',
    'parallel.pipeline', 'parallel.ring', 'obs.watchdog', 'obs.slo',
    'serve', 'serve.protocol', 'serve.pool', 'serve.client', 'serve.metrics',
    'serve.server', 'transplant', 'transplant.hf'))

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


OBS_MODULES = ('obs', 'obs.events', 'obs.context', 'obs.spans', 'obs.metrics',
               'obs.manifest', 'obs.blackbox', 'utils.tracing')
# the serve daemon's modules a client or the watchdog imports: no torch
SERVE_CLIENT_MODULES = ('obs.watchdog', 'obs.slo', 'serve', 'serve.protocol',
                        'serve.pool', 'serve.client')


def test_obs_modules_import_neither_torch_jax_nor_timm():
    """The flight recorder's modules, as a decode worker may import them,
    pull in no torch (only the functions that need it import it), no jax,
    no JAX package and no timm."""
    code = ('import sys\n'
            + ''.join(f'import video_features_torch.{m}\n' for m in OBS_MODULES)
            + 'print(sorted(m for m in ("torch", "jax", "video_features_tpu", '
              '"timm") if m in sys.modules))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[]'


def test_serve_client_side_modules_import_neither_torch_nor_jax():
    """The stall watchdog, the SLOs and the serve package's protocol,
    pool and client import no torch, so a client of the daemon needs
    none, and no jax, no JAX package and no timm."""
    code = ('import sys\n'
            + ''.join(f'import video_features_torch.{m}\n'
                      for m in SERVE_CLIENT_MODULES)
            + 'print(sorted(m for m in ("torch", "jax", "video_features_tpu", '
              '"timm") if m in sys.modules))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[]'


def test_mesh_and_multihost_modules_import_neither_torch_nor_jax():
    """The worklist, multihost, mesh and pipeline modules import torch only
    inside the functions that use it (``torch.distributed`` included), and
    no jax, no JAX package and no timm."""
    code = ('import sys\n'
            + ''.join(f'import video_features_torch.parallel.{m}\n'
                      for m in ('worklist', 'distributed', 'mesh', 'pipeline'))
            + 'print(sorted(m for m in ("torch", "jax", "video_features_tpu", '
              '"timm") if m in sys.modules))')
    proc = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == '[]'


def test_a_farm_worker_with_the_recorder_attached_stays_torch_free(tmp_path):
    """With a span recorder on the tracer and a black box on the farm, a
    spawned worker decoding a real clip imports neither torch nor jax nor
    the JAX package, and its decode spans come back on its own pid lane."""
    from tests.test_torch_farm import ProbeRecipe, _drain
    from tools.make_sample_video import write_noise_clip
    from video_features_torch.farm import DecodeFarm, StackRecipe
    from video_features_torch.obs.blackbox import BlackBox
    from video_features_torch.obs.spans import SpanRecorder
    from video_features_torch.utils.tracing import Tracer
    clip = write_noise_clip(tmp_path / 'c.mp4', 14, w=80, h=60, seed=3)
    recipe = StackRecipe(win=5, step=4, batch_size=8, fps=None, total=None,
                         tmp_path=str(tmp_path), keep_tmp=False, backend='cv2',
                         transform=('edge_resize', 32, 'bilinear'))
    rec = SpanRecorder()
    farm = DecodeFarm(ProbeRecipe(recipe), workers=1, ring_bytes=1 << 20,
                      tracer=Tracer(recorder=rec),
                      blackbox=BlackBox(str(tmp_path / 'pm'),
                                        recorders=lambda: [rec]))
    tasks, got, _ = _drain(farm, [clip])
    assert not tasks[0].failed and len(got[str(clip)]) == 3
    assert tasks[0].info['modules'] == []
    decode = [e for e in rec.snapshot() if e['name'] == 'decode']
    assert [e['pid'] for e in decode] == [tasks[0].info['pid']] * 3
    assert not (tmp_path / 'pm').exists()      # nothing died
