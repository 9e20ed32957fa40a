"""BENCHMARK.json and the files it names: a cell's configuration,
traffic mix, correctness limits and metric readers, each found by name."""
from __future__ import annotations

import importlib
import importlib.util
import json
from functools import lru_cache
from pathlib import Path
from typing import Callable, Dict, List, Optional

PORTBENCH = Path(__file__).resolve().parents[1]
ROOT = PORTBENCH.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / 'BENCHMARK.json')


def _applies(metric: dict, workload: str) -> bool:
    return 'workloads' not in metric or workload in metric['workloads']


def family(name: str):
    """``portbench/reference/<name>.py``, the module a configuration's
    ``reference`` names: its ``compare`` and ``flops``."""
    try:
        module = importlib.import_module(f'portbench.reference.{name}')
    except ModuleNotFoundError as e:
        raise ValueError(f'no reference module portbench/reference/{name}.py') from e
    missing = [f for f in ('compare', 'flops') if not callable(getattr(module, f, None))]
    if missing:
        raise ValueError(f'portbench/reference/{name}.py has no {" or ".join(missing)}')
    return module


class Cell:
    """One entry of ``workloads`` with everything it names: ``config`` (the
    configuration's entry), ``config_file``, ``family`` (the reference
    module its ``reference`` names), ``traffic`` (the mix's data file),
    ``limits`` (the correctness limits), and the end-to-end and
    per-layer metrics it reports."""

    def __init__(self, bench: dict, name: str, root: Path = ROOT) -> None:
        cells = {w['name']: w for w in bench['workloads']}
        if name not in cells:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json '
                           f'(have: {", ".join(sorted(cells))})')
        self.name = name
        self.workload = cells[name]
        self.chips = int(self.workload['chips'])
        self.config = {c['name']: c for c in bench['configs']}[self.workload['config']]
        self.config_file = load_json(root / self.config['file'])
        self.family = family(self.config_file['reference'])
        self.traffic_name = self.workload['traffic']
        here = root / 'portbench'
        self.traffic = load_json(here / 'traffic' / f'{self.traffic_name}.json')
        self.limits = load_json(here / 'limits' / f'{name}.json')
        self.corpus_root = here / '.corpus'
        self.end_to_end = [m for m in bench['end_to_end'] if _applies(m, name)]
        self.per_layer = [m for m in bench['per_layer'] if _applies(m, name)]

    def metrics(self, trace: bool) -> List[dict]:
        return self.per_layer if trace else self.end_to_end


@lru_cache(maxsize=None)
def reader(name: str) -> Callable:
    """``portbench/metrics/<name>.py``'s ``read(run) -> float | None``."""
    path = PORTBENCH / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'portbench_metric_{name.replace(".", "_").replace("-", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_metrics(metrics: List[dict], run) -> Dict[str, dict]:
    """{name: {"value", "unit"}} for each metric whose reader found
    something to read."""
    out = {}
    for m in metrics:
        value: Optional[float] = reader(m['name'])(run)
        if value is not None:
            out[m['name']] = {'value': float(value), 'unit': m['unit']}
    return out
