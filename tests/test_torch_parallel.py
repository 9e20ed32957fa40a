"""The port's mesh layer on the CPU (video_features_torch/parallel/{mesh,
pipeline,ring}.py, the replicas of ``extract/base.py``, the families'
``data_parallel``, the mesh-aware packed and fused loops,
``ops/attention.py::ring_attention``, ``models/vit.py::
forward_sequence_parallel`` and timm's ``sequence_parallel``), against
the JAX package's on the same seeded inputs and weights.

The port's device list is patched to ``[cpu] * n``
(``utils/device.py::local_devices``), as the JAX tests force host
devices; the JAX side runs on ``n`` of the eight forced host CPU devices
(tests/conftest.py) by patching its ``jax_devices_all``."""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from tools.make_sample_video import write_noise_clip, write_tone
from video_features_torch.config import load_config
from video_features_torch.parallel import mesh as port_mesh
from video_features_torch.registry import create_extractor
from video_features_torch.utils.output import make_path

JAX_REL_L2 = 1e-5     # float32 on both sides, different sum orders
DP_TOL = dict(atol=2e-5, rtol=1e-5)   # the JAX tests' data_parallel bound
CPU = torch.device('cpu')


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    """One torch thread: the convolutions are held to 1e-5 (oneDNN's
    multi-threaded fp32 convolution reorders sums), and the tier-1 run has
    several workers per machine."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, ref) -> float:
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def cpu_devices(monkeypatch, n: int) -> None:
    """The port sees ``n`` local devices, all the CPU."""
    import video_features_torch.utils.device as dev
    monkeypatch.setattr(dev, 'local_devices', lambda device: [CPU] * n)


def jax_devices(monkeypatch, n: int) -> None:
    """The JAX package's data-parallel mesh spans ``n`` host devices."""
    import video_features_tpu.utils.device as dev
    monkeypatch.setattr(dev, 'jax_devices_all',
                        lambda device: jax.local_devices()[:n])


# -- the mesh helpers against the JAX package's ------------------------------


@pytest.mark.parametrize('n,time_parallel', [(8, None), (1, None), (8, 4),
                                             (6, 3), (6, 4), (5, None)])
def test_factor_mesh_shape_matches_jax(n, time_parallel):
    from video_features_tpu.parallel import mesh as jax_mesh

    def outcome(fn):
        try:
            return fn(n, time_parallel)
        except ValueError as e:
            return str(e)
    assert outcome(port_mesh.factor_mesh_shape) == outcome(
        jax_mesh.factor_mesh_shape)


@pytest.mark.parametrize('n_devices,time_parallel', [(None, None), (0, None),
                                                     (4, 1), (2, 2), (8, 8),
                                                     (3, None), (9, None)])
def test_make_mesh_matches_jax(n_devices, time_parallel):
    """Shapes over eight devices, and the over-ask's message."""
    from video_features_tpu.parallel import mesh as jax_mesh

    def outcome(fn, devices):
        try:
            return dict(fn(n_devices, time_parallel, devices=devices).shape)
        except ValueError as e:
            return str(e)
    assert outcome(port_mesh.make_mesh, [CPU] * 8) == outcome(
        jax_mesh.make_mesh, jax.local_devices()[:8])


@pytest.mark.parametrize('batch', [0, 1, 3, 4, 7, 8])
@pytest.mark.parametrize('ndev', [1, 2, 4])
def test_batch_planning_matches_jax(batch, ndev):
    """round_batch_to_data_axis, plan_device_batch, shard_error and
    require_shardable: the same numbers and the same messages."""
    from video_features_tpu.parallel import mesh as jax_mesh
    port = port_mesh.make_mesh(devices=[CPU] * ndev, time_parallel=1)
    ref = jax_mesh.make_mesh(devices=jax.local_devices()[:ndev], time_parallel=1)

    def outcomes(m, fn):
        out = []
        for f in (fn.round_batch_to_data_axis, fn.plan_device_batch,
                  fn.require_shardable):
            try:
                out.append(f(batch, m))
            except ValueError as e:
                out.append(str(e))
        return out + [fn.shard_error(batch, m)]
    assert outcomes(port, port_mesh) == outcomes(ref, jax_mesh)


def test_replicate_and_split_batch():
    """One params copy per data shard on its device (a device listed twice
    shares its tensors), and contiguous row blocks in shard order."""
    mesh = port_mesh.make_mesh(devices=[CPU] * 3, time_parallel=1)
    params = {'a': torch.ones(2), 'b': {'c': torch.zeros(3)}}
    reps = port_mesh.replicate(params, mesh)
    assert len(reps) == 3 and all(r['b']['c'] is params['b']['c'] for r in reps)
    batch = np.arange(12).reshape(6, 2)
    parts = port_mesh.split_batch(batch, mesh)
    assert [p.tolist() for p in parts] == [batch[0:2].tolist(),
                                          batch[2:4].tolist(), batch[4:6].tolist()]
    with pytest.raises(ValueError, match='packed batch 5 cannot shard over 3'):
        port_mesh.split_batch(batch[:5], mesh)


# -- each family's data_parallel ---------------------------------------------


@pytest.fixture(scope='module')
def media(tmp_path_factory):
    d = tmp_path_factory.mktemp('dpmedia')
    write_tone(d / 't.wav', seconds=3.5)
    return {
        'frames': str(write_noise_clip(d / 'f.mp4', 9, seed=1)),
        'stacks': str(write_noise_clip(d / 's.mp4', 25, seed=2)),
        's3d': str(write_noise_clip(d / 's3.mp4', 33, seed=3)),
        'raft': str(write_noise_clip(d / 'r.mp4', 10, w=96, h=72, seed=4)),
        'wav': str(d / 't.wav'),
    }


# family → (media, overrides); each batch rounds up over 2 devices
DP_FAMILIES = {
    'resnet': ('frames', dict(model_name='resnet18', batch_size=3)),
    'clip': ('frames', dict(model_name='ViT-B/32', batch_size=3)),
    'timm': ('frames', dict(model_name='vit_tiny_patch16_224', batch_size=3)),
    'r21d': ('stacks', dict(stack_size=4, step_size=4, batch_size=3)),
    's3d': ('s3d', dict(stack_size=16, step_size=16, batch_size=1)),
    'i3d': ('stacks', dict(streams='rgb', stack_size=10, step_size=10,
                           batch_size=1, concat_rgb_flow=False)),
    'vggish': ('wav', dict(batch_size=3)),
    'raft': ('raft', dict(side_size=64, raft_iters=2, batch_size=3)),
}


def _args(ft, path, out, **kw):
    return dict(dict(video_paths=path, device='cpu', allow_random_weights=True,
                     output_path=str(out), tmp_path=str(out) + '_tmp',
                     decode_workers=1, **DP_FAMILIES[ft][1]), **kw)


@pytest.mark.parametrize('ft', list(DP_FAMILIES))
def test_data_parallel_matches_one_device_and_the_jax_package(
        ft, media, tmp_path, monkeypatch):
    """data_parallel over two devices: the batch rounds up to a multiple
    of 2, each shard runs on its replica, and the features hold the port's
    one-device run at the JAX tests' bound and the JAX package's
    data_parallel run on two host devices at rel L2 1e-5."""
    from video_features_tpu.config import load_config as jax_load_config
    from video_features_tpu.registry import create_extractor as jax_create
    path = media[DP_FAMILIES[ft][0]]
    single = create_extractor(load_config(ft, overrides=_args(
        ft, path, tmp_path / 'one'))).extract(path)
    cpu_devices(monkeypatch, 2)
    ex = create_extractor(load_config(ft, overrides=_args(
        ft, path, tmp_path / 'dp', data_parallel=True)))
    assert ex._mesh.shape == {'data': 2, 'time': 1} and len(ex._replicas) == 2
    assert ex.batch_size % 2 == 0
    got = ex.extract(path)
    jax_devices(monkeypatch, 2)
    ref = jax_create(jax_load_config(ft, overrides=_args(
        ft, path, tmp_path / 'jax', data_parallel=True,
        decode_backend='cv2'))).extract(path)
    assert got.keys() == single.keys()
    for key in got:
        assert got[key].shape == single[key].shape == ref[key].shape, key
        if key in ('fps', 'timestamps_ms'):
            np.testing.assert_array_equal(got[key], single[key])
            np.testing.assert_array_equal(got[key], ref[key])
            continue
        np.testing.assert_allclose(got[key], single[key], **DP_TOL)
        assert rel_l2(got[key], ref[key]) <= JAX_REL_L2, key


def test_raft_halo_shards_are_the_jax_layout(monkeypatch, tmp_path, media):
    """Each shard of B + 1 consecutive frames is a run of k + 1 with the
    boundary frame in both neighbours, the JAX package's layout."""
    from video_features_tpu.extract.raft import ExtractRAFT as JaxRAFT
    cpu_devices(monkeypatch, 4)
    ex = create_extractor(load_config('raft', overrides=_args(
        'raft', media['raft'], tmp_path, data_parallel=True, batch_size=8)))
    frames = np.arange(9 * 2).reshape(9, 2)
    shards = ex._put_batch(frames)
    assert [s[:, 0].tolist() for s in shards] == [[0, 2, 4], [4, 6, 8],
                                                   [8, 10, 12], [12, 14, 16]]
    jex = JaxRAFT.__new__(JaxRAFT)
    jex._mesh = port_mesh.make_mesh(devices=[CPU] * 4, time_parallel=1)
    np.testing.assert_array_equal(np.concatenate(shards),
                                  jex._halo_shards(frames))


# the JAX package's bound for RAFT over halo shards
# (tests/test_parallel.py::test_raft_halo_shard_dp_matches_single_device):
# a shard's convolutions run at another batch than one device's, and
# random weights amplify the reordered sums through the GRU iterations
RAFT_HALO_TOL = dict(atol=5e-4, rtol=1e-4)


@pytest.mark.parametrize('ndev', [2, 4])
def test_raft_halo_flows_match_one_device(ndev, media, tmp_path, monkeypatch):
    """The RAFT family over 2 and 4 halo shards, a tail batch included
    (9 pairs at batch 4 or 8): the flows of one device, at the JAX
    package's bound for halo shards."""
    path = media['raft']
    over = dict(batch_size=ndev * 2 if ndev == 2 else ndev)
    single = create_extractor(load_config('raft', overrides=_args(
        'raft', path, tmp_path / 'one', **over))).extract(path)
    cpu_devices(monkeypatch, ndev)
    ex = create_extractor(load_config('raft', overrides=_args(
        'raft', path, tmp_path / 'dp', data_parallel=True, **over)))
    got = ex.extract(path)
    assert got['raft'].shape == single['raft'].shape == (9, 2, 64, 85)
    np.testing.assert_allclose(got['raft'], single['raft'], **RAFT_HALO_TOL)
    np.testing.assert_array_equal(got['timestamps_ms'], single['timestamps_ms'])


def test_two_stream_i3d_data_parallel_matches_one_device(media, tmp_path,
                                                         monkeypatch):
    """Both I3D towers and RAFT (1 iteration) with the two windows' batch
    split over two replicas."""
    path = media['stacks']
    over = dict(streams=None, raft_iters=1)
    single = create_extractor(load_config('i3d', overrides=_args(
        'i3d', path, tmp_path / 'one', **over))).extract(path)
    cpu_devices(monkeypatch, 2)
    got = create_extractor(load_config('i3d', overrides=_args(
        'i3d', path, tmp_path / 'dp', data_parallel=True, **over))).extract(path)
    for stream in ('rgb', 'flow'):
        assert got[stream].shape == single[stream].shape == (2, 1024)
        np.testing.assert_allclose(got[stream], single[stream], **DP_TOL)


def test_data_parallel_manifest_and_unsupported_family_warns(
        media, tmp_path, monkeypatch):
    """The manifest of a data_parallel run names its mesh; a family
    outside DATA_PARALLEL_FEATURES warns and runs on one device."""
    from video_features_torch import registry
    cpu_devices(monkeypatch, 2)
    path = media['frames']
    ex = create_extractor(load_config('resnet', overrides=_args(
        'resnet', path, tmp_path, data_parallel=True,
        manifest_out=str(tmp_path / 'm.json'))))
    ex._extract(path)
    ex.finish_obs()
    mesh = json.loads((tmp_path / 'm.json').read_text())['mesh']
    assert mesh == {'mesh_devices': 2, 'shape': {'data': 2, 'time': 1},
                    'devices': ['d0', 'd1'], 'capacity_per_device': 2,
                    'global_batch': 4, 'compute_dtype': 'float32'}
    monkeypatch.setattr(registry, 'DATA_PARALLEL_FEATURES', frozenset({'i3d'}))
    with pytest.warns(UserWarning, match='data_parallel is not implemented for resnet'):
        args = load_config('resnet', overrides=_args('resnet', path, tmp_path,
                                                     data_parallel=True))
    assert args['data_parallel'] is False


# -- mesh_devices: the packed and fused loops over several devices ------------


@pytest.fixture(scope='module')
def worklist(tmp_path_factory):
    """9 + 4 + 14 = 27 frames: at 4 per device over 2 devices (global 8)
    three full batches and an uneven tail of 3, the second shard's slice
    all padding."""
    d = tmp_path_factory.mktemp('meshvids')
    return [str(write_noise_clip(d / f'mv{i}.mp4', n, seed=i))
            for i, n in enumerate((9, 4, 14))]


def _resnet(paths, out, **kw):
    return create_extractor(load_config('resnet', overrides=dict(
        video_paths=paths, device='cpu', model_name='resnet18', batch_size=4,
        allow_random_weights=True, on_extraction='save_numpy',
        output_path=str(out), tmp_path=str(out) + '_tmp', decode_workers=1,
        pack_across_videos=True, **kw)))


def _bytes(root):
    return {str(f.relative_to(root)): f.read_bytes()
            for f in sorted(Path(root).rglob('*.npy'))}


@pytest.fixture(scope='module')
def one_device_tree(worklist, tmp_path_factory):
    root = tmp_path_factory.mktemp('mesh1')
    ex = _resnet(worklist, root / 'cfg')
    ex.extract_packed(worklist)
    return ex.output_path


def test_configure_mesh_resolves_and_refuses(worklist, tmp_path, monkeypatch):
    """mesh_devices=0 is every local device; an over-ask names the counts;
    a negative value and mesh_devices with data_parallel are the JAX
    package's errors and warning."""
    cpu_devices(monkeypatch, 3)
    assert _resnet(worklist, tmp_path, mesh_devices=0).mesh_devices == 3
    with pytest.raises(ValueError, match=r'mesh_devices=4 but this host has '
                                         r'only 3 local cpu device\(s\)'):
        _resnet(worklist, tmp_path, mesh_devices=4)
    with pytest.raises(ValueError, match='mesh_devices must be >= 0'):
        _resnet(worklist, tmp_path, mesh_devices=-1)
    with pytest.warns(UserWarning, match='data_parallel already owns'):
        ex = _resnet(worklist, tmp_path, mesh_devices=2, data_parallel=True)
    assert ex.mesh_devices == 1 and len(ex._replicas) == 3


def test_packed_mesh_framewise_byte_identical_with_its_record(
        worklist, one_device_tree, tmp_path, monkeypatch):
    """resnet18 packed at mesh_devices=2 writes the bytes of one device;
    the tail is masked, not stalled (per-device occupancy 15 and 12 of
    16); the manifest records the mesh."""
    cpu_devices(monkeypatch, 2)
    ex = _resnet(worklist, tmp_path / 'cfg', mesh_devices=2, profile=True,
                 manifest_out=str(tmp_path / 'm.json'))
    report = {}
    real_reset = ex.tracer.reset
    ex.tracer.reset = lambda: report.update(ex.tracer.report()) or real_reset()
    ex.extract_packed(worklist)
    ex.finish_obs()
    assert _bytes(ex.output_path) == _bytes(one_device_tree)
    model = report['model']
    assert (model['count'], model['occ_valid'], model['occ_capacity']) == (4, 27, 32)
    assert {d: (r['occ_valid'], r['occ_capacity'])
            for d, r in model['occ_device'].items()} == {'d0': (15, 16),
                                                          'd1': (12, 16)}
    doc = json.loads((tmp_path / 'm.json').read_text())
    assert doc['mesh'] == {'mesh_devices': 2, 'shape': {'data': 2, 'time': 1},
                           'devices': ['d0', 'd1'], 'capacity_per_device': 4,
                           'global_batch': 8, 'compute_dtype': 'float32'}
    assert doc['stages']['model']['occ_device']['d1']['occ_valid'] == 12


def test_packed_mesh_poisoned_video_fails_alone(worklist, one_device_tree,
                                                tmp_path, monkeypatch):
    """A decoder that dies after one window entered a two-shard batch: that
    video writes nothing, the others write one device's bytes."""
    cpu_devices(monkeypatch, 2)
    ex = _resnet(worklist, tmp_path / 'cfg', mesh_devices=2)
    victim = worklist[2]
    orig = ex.packed_windows

    def flaky(task):
        it = orig(task)
        if task.path == victim:
            yield next(it)
            raise RuntimeError('decoder died mid-video')
        yield from it
    ex.packed_windows = flaky
    ex.extract_packed(worklist)
    assert not Path(make_path(ex.output_path, victim, 'resnet', '.npy')).exists()
    want = {k: v for k, v in _bytes(one_device_tree).items()
            if not k.startswith(Path(victim).stem)}
    assert _bytes(ex.output_path) == want


def test_packed_mesh_stack_family_byte_identical(worklist, tmp_path,
                                                 monkeypatch):
    """r21d's packed windows over two devices at 2 per device: the bytes of
    one device at batch 2."""
    def run(out, **kw):
        ex = create_extractor(load_config('r21d', overrides=dict(
            video_paths=worklist, device='cpu', stack_size=4, step_size=4,
            batch_size=2, allow_random_weights=True, on_extraction='save_numpy',
            output_path=str(out), tmp_path=str(out) + '_tmp',
            pack_across_videos=True, decode_workers=1, **kw)))
        ex.extract_packed(worklist)
        return ex
    one = run(tmp_path / 'one')
    cpu_devices(monkeypatch, 2)
    two = run(tmp_path / 'two', mesh_devices=2)
    assert two._packed_mesh_ndev == 2
    assert _bytes(two.output_path) == _bytes(one.output_path) != {}


def test_fused_worklist_over_a_mesh_is_byte_identical(worklist, tmp_path,
                                                      monkeypatch):
    """resnet18 and ViT-Tiny fused, each at mesh_devices=2: each family's
    bytes of its one-device fused run."""
    from video_features_torch.config import load_fused_configs
    from video_features_torch.parallel.packing import run_packed_fused

    def run(out, **kw):
        configs = load_fused_configs(['resnet', 'timm'], overrides=dict(
            video_paths=worklist, device='cpu', batch_size=4,
            allow_random_weights=True, on_extraction='save_numpy',
            output_path=str(out), tmp_path=str(out) + '_tmp', decode_workers=1,
            **{'resnet.model_name': 'resnet18',
               'timm.model_name': 'vit_tiny_patch16_224'}, **kw))
        exs = {fam: create_extractor(a) for fam, a in configs.items()}
        run_packed_fused(exs, list(worklist))
        return out
    one = run(tmp_path / 'one')
    cpu_devices(monkeypatch, 2)
    two = run(tmp_path / 'two', mesh_devices=2)
    assert _bytes(two) == _bytes(one) and len(_bytes(one)) == 2 * 3 * 3


def test_use_mesh_with_a_device_twice(worklist, one_device_tree, tmp_path):
    """A caller's mesh that lists one device twice (two shards on one
    card): two replicas sharing one params copy, one device's bytes."""
    ex = _resnet(worklist, tmp_path / 'cfg')
    ex.use_mesh(port_mesh.make_mesh(devices=[CPU, CPU], time_parallel=1))
    from video_features_torch.transplant import flatten
    leaves = [flatten(r.params) for r in ex._replicas]
    assert all(leaves[0][k] is leaves[1][k] for k in leaves[0])
    ex.extract_packed(worklist)
    assert _bytes(ex.output_path) == _bytes(one_device_tree)


# -- sequence parallelism ------------------------------------------------------


def _qkv(seed: int, s: int):
    rng = np.random.RandomState(seed)
    return [rng.randn(2, s, 3, 16).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize('s,n_valid', [(40, 40), (40, 37), (48, 45)])
def test_ring_attention_matches_jax_and_dense(s, n_valid):
    """ring_attention over 4 shards with the last keys padded and masked:
    the JAX ring on 4 host devices, and the port's dense attention over
    the valid keys, at rel L2 1e-5."""
    from jax.sharding import PartitionSpec as P

    from video_features_torch.ops.attention import dense_attention, ring_attention
    from video_features_tpu.ops.attention import ring_attention as jax_ring
    from video_features_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from video_features_tpu.utils.device import shard_map
    q, k, v = _qkv(s, s)
    valid = np.arange(s) < n_valid
    per = s // 4
    shard = lambda a: [torch.from_numpy(a[:, i * per:(i + 1) * per]) for i in range(4)]
    masks = [torch.from_numpy(valid[i * per:(i + 1) * per]) for i in range(4)]
    got = torch.cat(ring_attention(shard(q), shard(k), shard(v), kv_valid=masks),
                    dim=1).numpy()
    mesh = jax_make_mesh(devices=jax.local_devices()[:4], time_parallel=4)
    spec = P(None, 'time', None, None)
    with jax.default_matmul_precision('highest'):
        fn = shard_map(lambda a, b, c, m: jax_ring(a, b, c, 'time', kv_valid=m),
                       mesh=mesh, in_specs=(spec, spec, spec, P('time')),
                       out_specs=spec)
        ref = np.asarray(jax.jit(fn)(q, k, v, valid))
    assert rel_l2(got[:, :n_valid], ref[:, :n_valid]) <= JAX_REL_L2
    dense = dense_attention(*(torch.from_numpy(a) for a in (q, k[:, :n_valid],
                                                            v[:, :n_valid]))).numpy()
    assert rel_l2(got[:, :n_valid], dense[:, :n_valid]) <= JAX_REL_L2


def test_sequence_sharded_attention_matches_jax():
    """The array-level entry on a (1, 4) mesh, both packages."""
    from video_features_torch.parallel.ring import sequence_sharded_attention
    from video_features_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from video_features_tpu.parallel.ring import (
        sequence_sharded_attention as jax_ssa,
    )
    q, k, v = _qkv(7, 32)
    got = sequence_sharded_attention(
        port_mesh.make_mesh(devices=[CPU] * 4, time_parallel=4),
        *(torch.from_numpy(a) for a in (q, k, v))).numpy()
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_ssa(jax_make_mesh(devices=jax.local_devices()[:4],
                                               time_parallel=4), q, k, v))
    assert rel_l2(got, ref) <= JAX_REL_L2
    with pytest.raises(ValueError, match='does not split over 4 devices'):
        sequence_sharded_attention(
            port_mesh.make_mesh(devices=[CPU] * 4, time_parallel=4),
            *(torch.from_numpy(a[:, :30]) for a in (q, k, v)))


@pytest.fixture(scope='module')
def narrow_vit():
    """A narrow two-block ViT added to both packages' ARCHS."""
    from video_features_torch.models import vit
    from video_features_tpu.models import vit as jax_vit
    cfg = dict(width=64, layers=2, heads=2, patch=16)
    vit.ARCHS['vit_sp_test'] = jax_vit.ARCHS['vit_sp_test'] = cfg
    yield 'vit_sp_test'
    del vit.ARCHS['vit_sp_test'], jax_vit.ARCHS['vit_sp_test']


@pytest.mark.parametrize('distilled', [False, True], ids=['vit', 'deit'])
@pytest.mark.parametrize('shards,size', [(4, 224), (2, 256)])
def test_vit_sequence_parallel_matches_jax(narrow_vit, distilled, shards, size):
    """forward_sequence_parallel over 4 (197 tokens padded to 200) or 2
    shards (258 tokens at 256 px, the pos embed resampled), the DeiT head
    dispatch included: the JAX package's, and the port's one-device
    forward, at rel L2 1e-5."""
    from video_features_torch.models import vit
    from video_features_torch.transplant import params_from_torch
    from video_features_tpu.models import vit as jax_vit
    from video_features_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from video_features_tpu.transplant.torch2jax import transplant
    sd = vit.init_state_dict(arch=narrow_vit, distilled=distilled)
    x = np.random.RandomState(shards).rand(2, size, size, 3).astype(np.float32)
    params = params_from_torch(sd)
    mesh = port_mesh.make_mesh(devices=[CPU] * shards, time_parallel=shards)
    got = vit.forward_sequence_parallel(params, torch.from_numpy(x), mesh,
                                        arch=narrow_vit).numpy()
    one = vit.forward(params, torch.from_numpy(x), arch=narrow_vit).numpy()
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax.jit(lambda p, t: jax_vit.forward_sequence_parallel(
            p, t, jax_make_mesh(devices=jax.local_devices()[:shards],
                                time_parallel=shards), arch=narrow_vit))(
            transplant(sd), x))
    assert got.shape == ref.shape == (2, 64)
    assert rel_l2(got, ref) <= JAX_REL_L2
    assert rel_l2(got, one) <= JAX_REL_L2


def test_timm_sequence_parallel_extractor_matches_one_device(
        media, tmp_path, monkeypatch):
    """sequence_parallel=true through the extractor over 4 devices: the
    tokens' mesh is (1, 4) and the features those of one device."""
    path = media['frames']
    common = dict(video_paths=path, device='cpu', batch_size=4,
                  model_name='vit_tiny_patch16_224', allow_random_weights=True,
                  output_path=str(tmp_path / 'o'), tmp_path=str(tmp_path / 't'))
    single = create_extractor(load_config('timm', overrides=common)).extract(path)
    cpu_devices(monkeypatch, 4)
    sp = create_extractor(load_config('timm', overrides=dict(
        common, sequence_parallel=True)))
    assert sp._mesh.shape == {'data': 1, 'time': 4} and not sp._replicas
    got = sp.extract(path)
    np.testing.assert_allclose(got['timm'], single['timm'], **DP_TOL)


@pytest.mark.parametrize('over,match', [
    (dict(model_name='resnet18'), 'resnet has no token axis to shard'),
    (dict(data_parallel=True), 'not data_parallel=true'),
    (dict(compute_dtype='bfloat16'),
     'sequence_parallel \\+ compute_dtype=bfloat16 is not supported'),
])
def test_timm_sequence_parallel_refusals_are_the_jax_packages(
        over, match, media, tmp_path, monkeypatch):
    """Each refusal raises the JAX package's NotImplementedError before
    the weights load."""
    from video_features_torch.extract import timm as timm_ex

    def refuse(*a, **k):
        raise AssertionError('weights loaded before the refusal')
    monkeypatch.setattr(timm_ex.ExtractTIMM, 'load_params', refuse)
    args = load_config('timm', overrides=dict(dict(
        video_paths=media['frames'], device='cpu', sequence_parallel=True,
        model_name='vit_tiny_patch16_224', allow_random_weights=True,
        output_path=str(tmp_path / 'o'), tmp_path=str(tmp_path / 't')), **over))
    with pytest.raises(NotImplementedError, match=match):
        create_extractor(args)
