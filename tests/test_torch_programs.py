"""vft-programs on the port (``video_features_torch/analysis/programs.py``):
the ``torch.export`` program lock.

  * planted toys trip each of the six rules (and a clean toy trips none);
  * the lock round-trips, and injected drift is reported; a graph hash
    under another torch release is a note, under the same release drift;
  * the shipped lock: resnet on every lane and r21d on float32 are clean
    against it here (every family in the slow lane and on the card,
    ``chip_smoke.py`` phase 28 (b)); it covers the JAX lock's keys with
    the JAX batch, output and parameter census, except the recorded
    differences below;
  * the kernels in the graph: RAFT traced on fake CUDA tensors holds one
    ``vft::`` lookup and two GRU directions per iteration, on CPU tensors
    none; an exported program runs as its eager step does;
  * ``family_lock_hashes`` and the run manifest's ``programs_lock``.
"""
import json
from pathlib import Path

import numpy as np
import pytest
import torch

from video_features_torch.analysis.core import EXIT_CLEAN, EXIT_FINDINGS
from video_features_torch.analysis.programs import (
    ALL_PINNED, LANES, MESH_WIDTHS, ProgramSpec, build_family, check_program,
    collect, default_lock_path, diff_lock, export_program, family_lock_hashes,
    hash_matches, kernel_nodes, lane_families, load_lock, main, mesh_key,
    ops_census, parse_mesh_key, program_mesh, program_signature, sharded,
    write_lock,
)

REPO_ROOT = Path(__file__).resolve().parent.parent
JAX_LOCK = REPO_ROOT / 'PROGRAMS.lock.json'

# where the port's lock differs from the JAX lock on a compared field, and
# why (README, port section)
RECORDED = {
    ('vggish', 'batch'): 'the VGG takes torchvggish\'s (B, 1, 96, 64) '
                         'layout, float32 on every lane (the bf16 lane '
                         'casts inside the step)',
    ('index', 'out'): 'torch.sort gives int64 row indices (lax.top_k: int32)',
    ('index', 'out_tree'): 'topk returns a tuple (the JAX program a list)',
    ('index', 'num_partitions'): 'the index service runs one device: its '
                                 'program is the same at every width',
}


def meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device='meta')


PARAMS = {'w': meta(8)}
BATCH = meta(4, 8, dtype=torch.uint8)


def rules(fn, args=(PARAMS, BATCH), device='cuda', lane='float32',
          width=1, **spec_kw):
    spec = ProgramSpec('step', fn, args, partitions=width, **spec_kw)
    sig, ep = program_signature(spec, device)
    mesh = program_mesh(width)
    return sig, {f.rule for f in check_program(spec, sig, ep, 'toy', width,
                                               mesh, lane)}


# -- the rules ---------------------------------------------------------------

def test_clean_toy_has_no_findings_and_a_full_signature():
    sig, found = rules(lambda p, b: b.float() * p['w'])
    assert found == set()
    assert sig['batch'] == {'shape': [4, 8], 'dtype': 'uint8'}
    assert sig['out'] == [{'shape': [4, 8], 'dtype': 'float32'}]
    assert sig['out_tree'] == 'PyTreeDef(*)'
    assert sig['params'] == {'float32': {'arrays': 1, 'bytes': 32}}
    assert sig['const_bytes'] == 0 and sig['kernels'] == 0
    assert sig['num_partitions'] == 1
    assert sig['ops'] == {'aten.mul.Tensor': 1, 'aten.to.dtype': 1}
    assert len(sig['graph_sha256']) == 64
    assert sig['torch'] == torch.__version__


def test_no_f64_catches_a_planted_promotion():
    assert rules(lambda p, b: (b.double() * p['w']).float())[1] == {'no-f64'}


def test_no_host_callback_catches_item():
    assert rules(lambda p, b: b.float() * b.float().sum().item())[1] == \
        {'no-host-callback'}


def test_const_budget_catches_a_closure_captured_weight():
    weight = torch.ones(1024, 512)            # 2 MiB, not an input
    sig, found = rules(lambda p, b: b.float() @ weight[:8] * p['w'].sum(),
                       device='cpu')
    assert found == {'const-budget'}
    assert sig['const_bytes'] >= 1024 * 512 * 4


def test_bf16_census_catches_an_fp32_survivor():
    assert rules(lambda p, b: b.float() * p['w'], lane='bfloat16')[1] == \
        {'bf16-census'}
    bf16 = {'w': meta(8, dtype=torch.bfloat16)}
    assert rules(lambda p, b: b.float() * p['w'].float(), (bf16, BATCH),
                 lane='bfloat16')[1] == set()


def test_int8_census_catches_unquantized_params():
    assert rules(lambda p, b: b.float() * p['w'], lane='int8')[1] == \
        {'int8-census'}


def test_shardable_names_an_indivisible_batch():
    odd = meta(3, 8, dtype=torch.uint8)
    assert rules(lambda p, b: b.float() * p['w'], (PARAMS, odd),
                 width=2)[1] == {'shardable'}
    assert rules(lambda p, b: b.float() * p['w'], width=2)[1] == set()


def test_spec_ok_accepts_a_finding_with_its_rationale():
    assert rules(lambda p, b: (b.double() * p['w']).float(),
                 ok={'no-f64': 'a planted promotion'})[1] == set()


def test_sharded_program_is_the_per_shard_step_concatenated():
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(6, 5, generator=gen)
    w = torch.randn(5, 3, generator=gen)

    def step(p, b):
        return {'y': b @ p, 'n': b.norm(dim=1)}
    out = sharded(step, 3)(w, x)
    assert torch.equal(out['y'], torch.cat([c @ w for c in x.chunk(3)]))
    assert torch.equal(out['n'], x.norm(dim=1))


def test_lane_and_key_helpers_roundtrip():
    assert lane_families('float32', ALL_PINNED) == ALL_PINNED
    assert set(lane_families('bfloat16', ALL_PINNED)) == {
        'r21d', 's3d', 'resnet', 'clip', 'timm', 'vggish'}
    assert set(lane_families('int8', ALL_PINNED)) == {'resnet', 'clip',
                                                      'timm'}
    for width in MESH_WIDTHS:
        for lane in LANES:
            assert parse_mesh_key(mesh_key(width, lane)) == (width, lane)


# -- the lock ----------------------------------------------------------------

@pytest.fixture(scope='module')
def index_live():
    return collect(('index',), MESH_WIDTHS, ('float32',))


def test_lock_roundtrips_and_repins_identically(index_live, tmp_path):
    live, findings = index_live
    assert findings == []
    path = tmp_path / 'lock.json'
    write_lock(path, live)
    first = path.read_bytes()
    write_lock(path, live)
    assert path.read_bytes() == first
    lock = load_lock(path)
    assert diff_lock(live, lock, ('index',)) == []
    assert hash_matches(live, lock) == (2, 2)


def test_injected_drift_is_reported_field_by_field(index_live, tmp_path):
    live, _ = index_live
    path = tmp_path / 'lock.json'
    write_lock(path, live)
    lock = load_lock(path)
    prog = lock['families']['index']['mesh1']['programs']['topk']
    prog['ops']['aten.mm.default'] = 1
    prog['kernels'] = 3
    prog['params'] = {'float16': {'arrays': 1, 'bytes': 1}}
    messages = [f.message for f in diff_lock(live, lock, ('index',))]
    for field in ('ops', 'kernels', 'params'):
        assert any(m.startswith(f'{field} drifted') for m in messages), field


def test_a_graph_hash_is_bound_to_its_torch_release(index_live, tmp_path):
    live, _ = index_live
    path = tmp_path / 'lock.json'
    write_lock(path, live)
    lock = load_lock(path)
    prog = lock['families']['index']['mesh2']['programs']['topk']
    prog['graph_sha256'] = '0' * 64
    notes = []
    found = diff_lock(live, lock, ('index',), notes=notes)
    assert [f.message.split(':')[0] for f in found] == \
        ['graph_sha256 drifted under the same torch ' + torch.__version__]
    assert notes == []
    prog['torch'] = '0.0.0+another'
    assert diff_lock(live, lock, ('index',), notes=notes) == []
    assert len(notes) == 1 and '0.0.0+another' in notes[0] \
        and torch.__version__ in notes[0]


def test_unknown_missing_and_stale_entries_are_drift(index_live, tmp_path):
    live, _ = index_live
    path = tmp_path / 'lock.json'
    write_lock(path, live)
    lock = load_lock(path)
    lock['families']['no-such-family'] = {}
    lock['families']['index']['mesh1']['programs']['old'] = {}
    keys = {(f.family, f.program) for f in diff_lock(live, lock, ('index',))}
    assert keys == {('no-such-family', '-'), ('index', 'old')}
    assert diff_lock(live, {'families': {}}, ('index',))[0].message.startswith(
        'index is not in the lock')


def test_cli_exit_codes(tmp_path, capsys):
    path = tmp_path / 'lock.json'
    assert main(['--families', 'index', '--lock', str(path),
                 '--write-lock']) == EXIT_CLEAN
    assert main(['--families', 'index', '--lock', str(path)]) == EXIT_CLEAN
    assert 'graph hashes matched 2/2' in capsys.readouterr().err
    lock = load_lock(path)
    lock['families']['index']['mesh1']['programs']['topk']['batch'] = {}
    path.write_text(json.dumps(lock))
    assert main(['--families', 'index', '--lock', str(path)]) == EXIT_FINDINGS
    assert main(['--families', 'no-such-family']) == 1
    assert main(['--lanes', 'float8']) == 1


# -- the shipped lock --------------------------------------------------------

def test_live_tree_clean_fast_families():
    """resnet on every lane and width, r21d on float32, against the
    shipped lock (every family: the slow lane and phase 28 (b))."""
    assert main(['--families', 'resnet']) == EXIT_CLEAN
    assert main(['--families', 'r21d', '--lanes', 'float32']) == EXIT_CLEAN


@pytest.mark.slow
def test_live_tree_clean_all_families():
    assert main([]) == EXIT_CLEAN


def test_shipped_lock_has_the_jax_lock_keys_and_census():
    ours = load_lock(default_lock_path())
    theirs = json.loads(JAX_LOCK.read_text())
    assert ours['schema'] == 'video_features_torch.programs_lock/1'
    ours, theirs = ours['families'], theirs['families']
    assert set(ours) == set(theirs) == set(ALL_PINNED)
    differences = set()
    for family in theirs:
        assert set(ours[family]) == set(theirs[family]), family
        for key in theirs[family]:
            a = ours[family][key]['programs']
            b = theirs[family][key]['programs']
            assert set(a) == set(b), (family, key)
            for name in b:
                for field in ('batch', 'out', 'params', 'out_tree',
                              'num_partitions'):
                    if a[name][field] != b[name][field]:
                        differences.add((family, field))
    assert differences == set(RECORDED)


def test_shipped_lock_pins_the_kernels_on_the_card_path():
    """The cuda-lane i3d and raft programs call the hand kernels: one
    lookup and two GRU directions per RAFT iteration (20) per shard;
    every other program calls none."""
    fams = load_lock(default_lock_path())['families']
    for family, fam in fams.items():
        for key, entry in fam.items():
            width, _ = parse_mesh_key(key)
            for name, sig in entry['programs'].items():
                vft = {k: v for k, v in sig['ops'].items()
                       if k.startswith('vft.')}
                if family in ('i3d', 'raft'):
                    assert vft == {'vft.corr_lookup_lanes.default': 20 * width,
                                   'vft.gru_direction.default': 40 * width}
                    assert sig['kernels'] == 60 * width
                else:
                    assert vft == {} and sig['kernels'] == 0, (family, key)


# -- the kernels in the graph --------------------------------------------------

@pytest.fixture(scope='module')
def small_raft():
    ex = build_family('raft', overrides={'raft_iters': 2,
                                         'precision': 'tensorfloat32'})
    spec = ex.program_specs()[0]
    return ex, ProgramSpec('flow_step', spec.fn,
                           (spec.args[0], meta(3, 64, 96, 3,
                                               dtype=torch.uint8)),
                           spec.kwargs)


def test_raft_on_fake_cuda_holds_the_kernel_ops(small_raft):
    _, spec = small_raft
    sig, ep = program_signature(spec, 'cuda')
    assert sig['kernels'] == 6 == kernel_nodes(ep)
    assert {k: v for k, v in sig['ops'].items() if k.startswith('vft.')} == \
        {'vft.corr_lookup_lanes.default': 2, 'vft.gru_direction.default': 4}
    gru_nodes = [n for n in ep.graph.nodes if n.op == 'call_function'
                 and 'gru_direction' in str(n.target)]
    # tensorfloat32: the one-pass instantiation; both axes per iteration
    assert [n.args[-1] for n in gru_nodes] == [1, 1, 1, 1]
    assert [n.args[-2] for n in gru_nodes] == ['w', 'h', 'w', 'h']
    assert sig['out'] == [{'shape': [2, 64, 96, 2], 'dtype': 'float32'}]


def test_raft_padded_lookup_is_its_own_op(small_raft, monkeypatch):
    _, spec = small_raft
    monkeypatch.setenv('VFT_RAFT_LOOKUP', 'pallas')
    sig, _ = program_signature(spec, 'cuda')
    assert sig['ops']['vft.corr_lookup.default'] == 2
    assert 'vft.corr_lookup_lanes.default' not in sig['ops']


def test_raft_on_cpu_tensors_holds_no_kernel_op(small_raft):
    _, spec = small_raft
    sig, ep = program_signature(spec, 'cpu')
    assert sig['kernels'] == 0 and kernel_nodes(ep) == 0
    assert not any(k.startswith('vft.') for k in ops_census(ep))


def test_exported_program_runs_as_its_eager_step(small_raft, tmp_path):
    """Exported from real tensors, then saved and loaded (as phase 28 (c)
    does on the card), the program computes the eager step's bytes."""
    torch.set_num_threads(1)
    ex, spec = small_raft
    gen = np.random.default_rng(3)
    frames = torch.from_numpy(gen.integers(0, 256, (3, 64, 96, 3),
                                           dtype=np.uint8))
    ep = export_program(spec.fn, (ex.params, frames), spec.kwargs)
    torch.export.save(ep, tmp_path / 'raft.pt2')
    loaded = torch.export.load(tmp_path / 'raft.pt2')
    with torch.inference_mode():
        eager = spec.fn(ex.params, frames, **spec.kwargs)
        exported = ep.module()(ex.params, frames)
        reloaded = loaded.module()(ex.params, frames)
    assert torch.equal(eager, exported)
    assert torch.equal(eager, reloaded)


# -- the lock's readers ---------------------------------------------------------

def test_family_lock_hashes_read_the_shipped_lock(tmp_path):
    hashes = family_lock_hashes('r21d')
    assert set(hashes) == {'mesh1', 'mesh2', 'mesh1@bfloat16',
                           'mesh2@bfloat16'}
    assert set(hashes['mesh1']) == {'step'}
    assert len(hashes['mesh1']['step']) == 64
    assert hashes['mesh1@bfloat16']['step'] != hashes['mesh1']['step']
    assert family_lock_hashes('not-a-family') == {}
    broken = tmp_path / 'broken.json'
    broken.write_text('{')
    assert family_lock_hashes('r21d', broken) == {}


def test_manifest_records_the_family_programs_lock(tmp_path):
    from video_features_torch.config import load_config
    from video_features_torch.registry import create_extractor
    args = load_config('resnet', overrides={
        'device': 'cpu', 'video_paths': ['x.mp4'], 'model_name': 'resnet18',
        'allow_random_weights': True,
        'manifest_out': str(tmp_path / 'manifest.json')})
    ex = create_extractor(args)
    doc = ex.manifest.document()
    assert doc['programs_lock'] == {'resnet': family_lock_hashes('resnet')}
    assert set(doc['programs_lock']['resnet']) == {
        mesh_key(w, lane) for w in MESH_WIDTHS for lane in LANES}
