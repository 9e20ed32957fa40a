"""The port's ``multihost`` (video_features_torch/parallel/{distributed,
worklist}.py and the CLI around them) on the CPU: two real processes of
``python -m video_features_torch ... multihost=true`` over gloo share a
worklist of four WAVs, as the JAX package's two-process test does with
``jax.distributed``; and the units (``shard_worklist`` against the JAX
package's, ``initialize``'s paths, the CLI's rules)."""
import os
import socket
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from tools.make_sample_video import write_tone
from video_features_torch.parallel import distributed
from video_features_torch.parallel.worklist import shard_worklist, shuffled
from video_features_torch.utils.output import make_path

REPO = Path(__file__).resolve().parents[1]
PROCESS_TIMEOUT_S = 120     # each process's own limit: a hang fails the test


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


@pytest.fixture
def wavs(tmp_path):
    paths = []
    for i in range(4):
        p = tmp_path / f'clip_{i}.wav'
        write_tone(p, seconds=1.1, freq=220.0 * (i + 1))
        paths.append(str(p))
    return paths


def _cli(rank, port, worklist, out, extra=()):
    return [sys.executable, '-m', 'video_features_torch', 'feature_type=vggish',
            'device=cpu', 'multihost=true',
            f'coordinator_address=127.0.0.1:{port}', 'num_processes=2',
            f'process_id={rank}', f'file_with_video_paths={worklist}',
            'allow_random_weights=true', 'batch_size=2',
            'on_extraction=save_numpy', f'output_path={out}',
            f'tmp_path={out}_tmp', *extra]


def test_two_process_multihost_cli(wavs, tmp_path):
    """Two CLI processes over gloo: disjoint interleaved shards (rank 0
    videos 0 and 2, rank 1 videos 1 and 3), every output written, both
    past the final barrier with exit code 0, and each output the bytes of
    a one-process run."""
    worklist = tmp_path / 'paths.txt'
    worklist.write_text('\n'.join(wavs) + '\n')
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS='1')
    procs = [subprocess.Popen(_cli(rank, port, worklist, tmp_path / 'out'),
                              env=env, cwd=str(REPO), text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for rank in (0, 1)]
    outs = []
    try:
        for rank, proc in enumerate(procs):
            stdout, stderr = proc.communicate(timeout=PROCESS_TIMEOUT_S)
            assert proc.returncode == 0, (
                f'rank {rank} failed:\n{stdout[-2000:]}\n{stderr[-2000:]}')
            outs.append(stdout)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    shards = [{v for v in wavs if f'] {v}' in stdout} for stdout in outs]
    assert shards == [{wavs[0], wavs[2]}, {wavs[1], wavs[3]}]
    single = subprocess.run(
        [sys.executable, '-m', 'video_features_torch', 'feature_type=vggish',
         'device=cpu', f'video_paths=[{",".join(wavs)}]',
         'allow_random_weights=true', 'batch_size=2', 'on_extraction=save_numpy',
         f'output_path={tmp_path / "single"}',
         f'tmp_path={tmp_path / "single_tmp"}'],
        env=env, cwd=str(REPO), capture_output=True, text=True,
        timeout=PROCESS_TIMEOUT_S)
    assert single.returncode == 0, single.stderr[-2000:]
    for v in wavs:
        got = Path(make_path(str(tmp_path / 'out' / 'vggish'), v, 'vggish', '.npy'))
        want = Path(make_path(str(tmp_path / 'single' / 'vggish'), v, 'vggish',
                              '.npy'))
        assert got.read_bytes() == want.read_bytes()
        feats = np.load(got)
        assert feats.shape == (1, 128) and np.isfinite(feats).all()


@pytest.mark.parametrize('n,shards', [(11, 3), (4, 2), (3, 4), (0, 2)])
def test_shard_worklist_matches_the_jax_package(n, shards):
    """Disjoint, complete, interleaved and deterministic, as the JAX
    package's; an out-of-range shard is its ValueError."""
    from video_features_tpu.parallel.worklist import shard_worklist as jax_shard
    paths = [f'v{i}.mp4' for i in range(n)]
    got = [shard_worklist(paths, shard_id=i, num_shards=shards)
           for i in range(shards)]
    assert got == [jax_shard(paths, shard_id=i, num_shards=shards)
                   for i in range(shards)]
    assert sorted(p for s in got for p in s) == sorted(paths)
    for bad in (-1, shards):
        with pytest.raises(ValueError, match='out of range'):
            shard_worklist(paths, shard_id=bad, num_shards=shards)


def test_shard_worklist_defaults_to_the_process_group(monkeypatch):
    """Without a group: rank 0 of 1, the whole list; with one, its rank
    and size."""
    paths = [f'v{i}' for i in range(5)]
    assert shard_worklist(paths) == paths
    monkeypatch.setattr(distributed, 'process_index', lambda: 1)
    monkeypatch.setattr(distributed, 'process_count', lambda: 2)
    assert shard_worklist(paths) == ['v1', 'v3']


def test_shuffled_is_a_seeded_permutation():
    paths = [f'v{i}' for i in range(20)]
    assert shuffled(paths, seed=7) == shuffled(paths, seed=7) != paths
    assert sorted(shuffled(paths, seed=7)) == sorted(paths)


@pytest.fixture
def group_calls(monkeypatch):
    """``torch.distributed.init_process_group`` recorded, not run."""
    import torch.distributed as dist
    calls = []
    monkeypatch.setattr(dist, 'init_process_group',
                        lambda backend, **kw: calls.append((backend, kw)))
    for key in distributed.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    return calls


def test_initialize_passes_the_coordinator_keys(group_calls):
    distributed.initialize('host:1234', 4, 2)
    ((backend, kw),) = group_calls
    assert (backend, kw['init_method'], kw['world_size'], kw['rank']) == (
        'gloo', 'tcp://host:1234', 4, 2)


def test_initialize_takes_torchruns_environment(group_calls, monkeypatch):
    for key, value in zip(distributed.ENV_KEYS, ('1', '2', '127.0.0.1', '29500')):
        monkeypatch.setenv(key, value)
    distributed.initialize()
    ((backend, kw),) = group_calls
    assert (backend, kw['init_method']) == ('gloo', 'env://')


def test_initialize_without_a_cluster_warns_and_runs_alone(group_calls):
    with pytest.warns(UserWarning, match='no cluster environment detected'):
        distributed.initialize()
    assert group_calls == []
    assert (distributed.process_index(), distributed.process_count()) == (0, 1)


def test_initialize_is_a_no_op_in_a_group(group_calls, monkeypatch):
    monkeypatch.setattr(distributed, 'is_initialized', lambda: True)
    with warnings.catch_warnings():
        warnings.simplefilter('error')
        distributed.initialize('host:1234', 2, 0)
    assert group_calls == []


def test_initialize_with_partial_keys_names_the_missing_ones(group_calls):
    with pytest.raises(ValueError, match='missing: num_processes, process_id'):
        distributed.initialize('host:1234')


def test_an_unreachable_coordinator_raises():
    """Rank 1 of 2 with nothing listening at the coordinator: the
    rendezvous times out and raises; the run never goes on alone."""
    code = ('import sys; sys.path.insert(0, %r)\n'
            'from video_features_torch.parallel import distributed\n'
            'distributed.initialize("127.0.0.1:%d", 2, 1, timeout_s=3)\n'
            % (str(REPO), _free_port()))
    proc = subprocess.run([sys.executable, '-c', code], capture_output=True,
                          text=True, timeout=PROCESS_TIMEOUT_S)
    assert proc.returncode != 0
    assert 'Error' in proc.stderr


def test_multihost_from_a_config_file_is_an_error(wavs, tmp_path, monkeypatch):
    """multihost set anywhere but the command line raises the JAX
    package's error, on the single-family and the fused path."""
    from video_features_torch import cli, config

    real = config.load_config

    def with_multihost(*a, **k):
        args = real(*a, **k)
        args['multihost'] = True
        return args
    monkeypatch.setattr(cli, 'load_config', with_multihost)
    argv = ['feature_type=vggish', 'device=cpu', f'video_paths={wavs[0]}',
            'allow_random_weights=true', f'output_path={tmp_path}']
    with pytest.raises(ValueError, match='multihost must be passed on the '
                                         'command line'):
        cli.main(argv)
    real_fused = config.load_fused_configs

    def fused_with_multihost(*a, **k):
        configs = real_fused(*a, **k)
        for args in configs.values():
            args['multihost'] = True
        return configs
    monkeypatch.setattr(cli, 'load_fused_configs', fused_with_multihost)
    with pytest.raises(ValueError, match='multihost must be passed on the '
                                         'command line'):
        cli.main(['features=[resnet,clip]', 'device=cpu',
                  f'video_paths={wavs[0]}', 'allow_random_weights=true',
                  f'output_path={tmp_path}'])


def test_cli_multihost_alone_takes_the_whole_list_in_order(
        wavs, tmp_path, monkeypatch, capsys):
    """multihost=true with no cluster: one process, the whole unshuffled
    list, every output written."""
    import torch.distributed as dist

    from video_features_torch import cli
    for key in distributed.ENV_KEYS:
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setattr(dist, 'init_process_group', lambda *a, **k: (
        pytest.fail('no process group without a cluster')))
    with pytest.warns(UserWarning, match='single-process run'):
        assert cli.main(['feature_type=vggish', 'device=cpu', 'multihost=true',
                         f'video_paths=[{",".join(wavs)}]', 'batch_size=2',
                         'allow_random_weights=true', 'on_extraction=save_numpy',
                         f'output_path={tmp_path / "out"}']) == 0
    out = capsys.readouterr().out
    assert [line.split('] ')[1] for line in out.splitlines()
            if line.startswith('[') and '] ' in line] == wavs
    for v in wavs:
        assert Path(make_path(str(tmp_path / 'out' / 'vggish'), v, 'vggish',
                              '.npy')).exists()
