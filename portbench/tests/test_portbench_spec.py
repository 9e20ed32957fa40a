"""The benchmark's files against its contract, on the CPU: every cell,
configuration, traffic mix, limit file and metric reader loads by name;
names, units and keys are of the allowed forms; the FLOP counter
reproduces PERF.md's bounds; the result line's keys; and what may not be
imported is not."""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path

import pytest

from portbench.harness import drivers, spec

BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]
METRICS = BENCH['end_to_end'] + BENCH['per_layer']


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_loads_by_name(name):
    cell = spec.Cell(BENCH, name)
    assert cell.config_file['name'] == cell.config['name']
    assert cell.traffic['driver'] in drivers.DRIVERS
    assert cell.limits, 'a cell compares at least one number'
    assert {m['name'] for m in cell.end_to_end} >= {'setup_s'}
    assert len(cell.end_to_end) >= 2 and cell.per_layer


@pytest.mark.parametrize('name', [c['name'] for c in BENCH['configs']])
def test_every_configuration_counts_the_ranges_it_wraps(name):
    """The reference module the configuration names counts the FLOPs of
    each range its ``ranges`` wraps, and of nothing else."""
    cell = spec.Cell(BENCH, next(w['name'] for w in BENCH['workloads']
                                 if w['config'] == name))
    per_item, per_call = cell.family.flops(cell)
    assert per_item > 0 and all(v > 0 for v in per_call.values())
    ranges = cell.config_file['ranges']
    assert set(per_call) == set(ranges)
    for where in ranges.values():
        module, attr = where.split(':')
        assert module.split('.')[0] == 'video_features_torch' and attr


def test_an_unknown_reference_is_refused():
    with pytest.raises(ValueError, match='no reference module'):
        spec.family('no_such_family')
    with pytest.raises(ValueError, match='has no compare or flops'):
        spec.family('video')


def test_the_flow_heads_last_conv_is_drawn_small():
    import torch

    from portbench.harness import weights
    sd = weights.make_weights({'raft': {'reference': 'raft'}}, 5, 'cpu')['raft']
    last = sd['update_block.flow_head.conv2.weight']
    assert 0.0005 < float(last.std()) < 0.002
    assert 0.03 < float(sd['update_block.flow_head.conv1.weight'].std()) < 0.07
    again = weights.make_weights({'raft': {'reference': 'raft'}}, 5, 'cpu')['raft']
    assert torch.equal(again['update_block.flow_head.conv2.weight'], last)


def test_the_window_counts_every_readback_inside_it():
    """Rows read back together form one burst: the window opens after the
    first burst and closes at the last one within ``seconds``; every row
    in between counts, whichever video it belongs to."""
    run = drivers.Run(spec.Cell(BENCH, CELLS[0]), 1.2, False, 'cpu')
    rows = [(0.0, 'a'), (0.0005, 'b')]
    for t in (0.5, 1.0, 1.6):
        rows += [(t + 1e-5 * i, 'ab'[i % 2]) for i in range(8)]
    inside = run.close_window(rows)
    assert len(inside) == 16 and (run.t_a, run.t_b) == (0.0005, 1.0 + 7e-5)


@pytest.mark.parametrize('metric', METRICS, ids=[m['name'] for m in METRICS])
def test_every_metric_has_a_reader(metric):
    assert callable(spec.reader(metric['name']))


def test_the_file_keeps_to_the_contract():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    names = [c['name'] for c in BENCH['configs']] + CELLS + [m['name'] for m in METRICS]
    for group in (BENCH['configs'], BENCH['workloads'], METRICS):
        assert len({x['name'] for x in group}) == len(group)
    for n in names:
        assert NAME.match(n), n
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith('portbench/') and not c['reduced']
        for text in (c['source'], c['why']):
            assert 1 <= len(text) <= 200 and '\n' not in text and '\t' not in text
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
        assert NAME.match(w['traffic'])
    e2e = {m['name']: m for m in BENCH['end_to_end']}
    for m in BENCH['end_to_end']:
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25
    for m in BENCH['per_layer']:
        assert m['moves'] in e2e and m['layer'] and '\n' not in m['layer']
        for cell in m['workloads']:
            moved = e2e[m['moves']]
            assert 'workloads' not in moved or cell in moved['workloads']
    for m in METRICS:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
        assert set(m) - {'workloads'} <= {'name', 'unit', 'better', 'bound',
                                          'source', 'layer', 'moves'}
        if m['name'].endswith('_roofline') or '_roofline.' in m['name']:
            assert m['unit'] == '%'
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_flop_counter_reproduces_the_kernel_bounds():
    """PERF.md's 3xTF32 bounds at the fused batch-8 shape (M = 176,128):
    the seven per-iteration convolutions 4.23e11, a GRU direction
    1.73e11."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from portbench.reference import raft
    sd = {n: torch.empty(s, device='meta') for n, s, _ in raft.leaves()}
    n, h, w = 128, 32, 43
    assert n * h * w == 176128
    net = torch.empty(n, 128, h, w, device='meta')
    corr = torch.empty(n, 324, h, w, device='meta')
    flow = torch.empty(n, 2, h, w, device='meta')

    def seven():
        raft.motion_encoder(sd, flow, corr)
        t = raft._conv(sd, 'update_block.flow_head.conv1', net, padding=1)
        raft._conv(sd, 'update_block.flow_head.conv2', t, padding=1)

    with FlopCounterMode(display=False) as fc:
        seven()
    assert fc.get_total_flops() == pytest.approx(4.232e11, rel=1e-3)
    split = raft._gru_split(sd)
    terms = raft.context_terms(split, net)
    with FlopCounterMode(display=False) as fc:
        raft.sep_conv_gru(split, terms, net, net)
    assert fc.get_total_flops() / 2 == pytest.approx(1.7314e11, rel=1e-3)


class _Trace:
    busy_s, window_s = 1.5, 2.0

    def breakdown(self, spans, offset):
        return {'device_ops': [['k', 1.0]], 'idle_gaps': [['d2h', 0.5]]}


class _Run:
    correct, attempted, failed, memory_peak_bytes = True, 10, 0, 123
    spans, offset_ns, device_trace = None, 0, _Trace()
    checks = {'flow_rel_l2': {'value': 1e-6, 'limit': 1e-4}}

    def __init__(self, traced):
        self.traced = traced


@pytest.mark.parametrize('traced', [False, True])
def test_the_result_line_has_the_contract_keys(traced, monkeypatch):
    import torch

    import portbench.run as run_mod
    monkeypatch.setattr(torch.cuda, 'get_device_name', lambda i=0: 'card')
    line = run_mod.result_line(_Run(traced), {'x': {'value': 1.0, 'unit': 's'}}, 1)
    keys = ['correct', 'attempted', 'failed', 'metrics', 'device']
    assert list(line) == keys + (['breakdown'] if traced else []) + ['checks']
    assert set(line['device']) == ({'platform', 'kind', 'count', 'memory_peak_bytes'}
                                   | ({'busy_s', 'window_s'} if traced else set()))
    assert set(line['breakdown'] if traced else {}) <= {'device_ops', 'idle_gaps'}


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split('.')[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            yield node.module.split('.')[0]
        elif isinstance(node, ast.Call) and getattr(node.func, 'attr', '') == 'import_module':
            arg = node.args[0] if node.args else None
            if isinstance(arg, ast.Constant):
                yield str(arg.value).split('.')[0]


SOURCES = sorted(spec.PORTBENCH.rglob('*.py'))


@pytest.mark.parametrize('path', SOURCES, ids=lambda p: str(p.relative_to(spec.ROOT)))
def test_no_benchmark_file_imports_jax_or_the_jax_package(path):
    assert not set(_imports(path)) & {'jax', 'jaxlib', 'flax', 'video_features_tpu'}


@pytest.mark.parametrize('path', sorted((spec.PORTBENCH / 'reference').glob('*.py')),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    assert 'video_features_torch' not in set(_imports(path))
    text = path.read_text()
    assert 'portbench.harness' not in text and 'portbench.tests' not in text


class _Ev:
    def __init__(self, kind, name, start, dur, corr=0):
        self._a = (kind, name, start, dur, corr)

    def activity_type(self):
        return self._a[0]

    def name(self):
        return self._a[1]

    def start_ns(self):
        return self._a[2]

    def duration_ns(self):
        return self._a[3]

    def correlation_id(self):
        return self._a[4]


def test_the_trace_reduction_counts_busy_time_and_ranges_once():
    """Two kernels of one range that overlap count their union; a kernel
    launched outside every range counts in no range; idle is the rest."""
    from portbench.harness import trace
    events = [
        _Ev('user_annotation', 'portbench.raft_update', 100, 50),
        _Ev('cuda_runtime', 'cudaLaunchKernel', 110, 1, 1),
        _Ev('cuda_runtime', 'cudaLaunchKernel', 120, 1, 2),
        _Ev('cuda_runtime', 'cudaLaunchKernel', 200, 1, 3),
        _Ev('kernel', 'a', 300, 100, 1),
        _Ev('kernel', 'b', 350, 100, 2),           # overlaps a: union 150
        _Ev('kernel', 'c', 600, 100, 3),           # launched outside the range
        _Ev('gpu_memcpy', 'Memcpy HtoD', 800, 50),
    ]
    dt = trace.DeviceTrace(events, 0, 1000)
    assert dt.busy_s == pytest.approx(300e-9)
    assert dt.range_calls == {'portbench.raft_update': 1}
    assert dt.range_s == {'portbench.raft_update': pytest.approx(150e-9)}
    assert [g for g in dt.idle_gaps()] == [(0, 300), (450, 600), (700, 800), (850, 1000)]
