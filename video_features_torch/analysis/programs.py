"""vft-programs: the program contract checker, on ``torch.export`` (port
of ``video_features_tpu/analysis/programs.py``).

vft-lint pins the Python-level contracts; the contracts that decide what
runs on the card — shapes, dtypes, what the step closes over, which hand
kernels it calls — live one level down, in the programs the hot paths
dispatch. This module exports every family's step (the module-level step
function its ``packed_step`` calls, with the same static arguments) with
``torch.export.export(strict=False)`` at the JAX lock's geometry, at mesh
widths {1, 2} and on every ``compute_dtype`` lane the family accepts
(``mesh<n>`` float32; ``mesh<n>@bfloat16`` for
``registry.BF16_FEATURES``; ``mesh<n>@int8`` for
``registry.INT8_FEATURES``). The inputs are fake tensors on the device
``cuda`` (``FakeTensorMode``) built from shapes and dtypes alone, so the
trace needs no GPU and touches no weight values; the wrappers of the
hand kernels then reach their ``torch.library`` ops (``vft::``), so a
program for the card names its kernels.

Each program's signature: ``batch`` and ``out`` (shape, dtype), the
``out_tree``, the ``params`` dtype census ``{dtype: {arrays, bytes}}``,
``const_bytes`` (tensors baked into the graph instead of passed in),
``num_partitions`` (the shards one step runs: the port's mesh drives
one replica per device from the host, so a width-n program is the
per-device step on n contiguous shards of the global batch,
concatenated), ``ops`` (a census of the graph's call targets), ``kernels``
(the ``vft::`` nodes), ``graph_sha256`` (over a normalized graph text)
and ``torch`` (the release that wrote the entry).

Rules (the JAX names): ``no-f64``; ``no-host-callback`` (a readback to
the host — ``.item()``, an op whose output shape depends on the data —
or a Python callable in the graph); ``shardable``
(``parallel/mesh.py::shard_error``); ``const-budget`` (1 MiB);
``bf16-census``; ``int8-census``. A family accepts a finding in its spec
(``ProgramSpec(ok={rule: rationale})``). Three JAX rules have no torch
counterpart and are not faked: ``no-weak-type`` (torch has no weak
types), ``donation`` (no buffer donation), and the XLA ``cost``
analysis.

Drift against ``analysis/PROGRAMS.lock.json`` in any field exits 2,
except ``graph_sha256`` under another torch release than the entry's:
the graph text is the release's, so that drift is printed with both
releases named and does not fail. The lock is written with
``--write-lock``.

torch is imported inside the functions that trace: the lock readers
(:func:`family_lock_hashes`, used by the run manifest) are pure stdlib.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import sys
import time
from collections import Counter
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Optional, Tuple

from video_features_torch.analysis.core import (
    EXIT_CLEAN, EXIT_ERROR, EXIT_FINDINGS,
)
from video_features_torch.registry import (
    BF16_FEATURES, EXTRACTORS, INT8_FEATURES,
)

LOCK_SCHEMA = 'video_features_torch.programs_lock/1'
DEFAULT_LOCK = 'PROGRAMS.lock.json'           # beside this module

# every family the lock covers (the registry's), and the index's query
# program, as in the JAX lock
FAMILIES = tuple(EXTRACTORS)
EXTRA_PROGRAMS = ('index',)
ALL_PINNED = FAMILIES + EXTRA_PROGRAMS
MESH_WIDTHS = (1, 2)
LANES = ('float32', 'bfloat16', 'int8')

RULES = ('no-f64', 'no-host-callback', 'shardable', 'const-budget',
         'bf16-census', 'int8-census')

# the device the lock's programs are traced for: the hot path's
DEVICE = 'cuda'

# default baked-constant budget per program: small epilogue constants
# (normalization mean/std, resize index tables) are fine; a weight folded
# into the graph is megabytes
CONST_BUDGET = 1 << 20

# the hand kernels' ops (ops/corr_lookup.py, ops/gru.py, ops/conv_tf32x3.py)
KERNEL_NAMESPACE = 'vft'

# ops whose output needs the data on the host (a readback mid-step)
_HOST_OPS = ('_local_scalar_dense', 'item', 'nonzero', 'masked_select',
             'unique', '_unique', '_unique2', 'unique_consecutive',
             'unique_dim', 'bincount', 'repeat_interleave')
# bookkeeping nodes torch.export adds in some releases and not in others;
# left out of the ops census and the graph hash
_BOOKKEEPING_OPS = ('_assert_tensor_metadata', '_assert_scalar',
                    '_assert_async', 'sym_constrain_range',
                    'sym_constrain_range_for_size')


def lane_families(lane: str, families: Iterable[str]) -> tuple:
    """The subset of ``families`` that builds on ``lane``: every family
    for float32, the registry's opt-in set for the fast lanes."""
    if lane == 'float32':
        return tuple(families)
    accepted = BF16_FEATURES if lane == 'bfloat16' else INT8_FEATURES
    return tuple(f for f in families if f in accepted)


def mesh_key(width: int, lane: str) -> str:
    """Lock entry key: ``mesh<n>`` for float32, ``mesh<n>@<lane>`` else."""
    return f'mesh{width}' if lane == 'float32' else f'mesh{width}@{lane}'


def parse_mesh_key(key: str) -> Tuple[int, str]:
    """Inverse of :func:`mesh_key`: ``'mesh2@bfloat16'`` → (2, 'bfloat16')."""
    base, _, lane = key.partition('@')
    try:
        width = int(base.replace('mesh', '') or 0)
    except ValueError:
        width = 0
    return width, (lane or 'float32')


# -- family build recipes ----------------------------------------------------

# overrides that build every family on a CPU host with no checkpoints and
# no video files: the lock pins program signatures, and random weights
# have the shapes and dtypes real checkpoints load to
_BASE_OVERRIDES: Dict[str, Any] = {
    'device': 'cpu',
    'video_paths': ['__programs_check__.mp4'],
    'allow_random_weights': True,
    'compilation_cache_dir': None,
}
_FAMILY_OVERRIDES: Dict[str, Dict[str, Any]] = {
    'timm': {'model_name': 'vit_base_patch16_224'},
}


def build_family(feature_type: str, compute_dtype: str = 'float32',
                 overrides: Optional[Mapping[str, Any]] = None):
    """The real extractor, built as production builds it
    (``registry.create_extractor`` over the merged config), on the CPU;
    its specs give the programs abstract inputs (shapes and dtypes).
    ``'index'`` is the feature index's query program."""
    if feature_type == 'index':
        from video_features_torch.index.search import IndexPrograms
        return IndexPrograms()
    import warnings

    from video_features_torch.config import load_config
    from video_features_torch.registry import create_extractor
    merged = dict(_BASE_OVERRIDES)
    merged.update(_FAMILY_OVERRIDES.get(feature_type, {}))
    if compute_dtype != 'float32':
        merged['compute_dtype'] = compute_dtype
    merged.update(overrides or {})
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')      # the placeholder video path
        return create_extractor(load_config(feature_type, overrides=merged))


# -- program specs -----------------------------------------------------------

class ProgramSpec:
    """One program a family exposes to the checker.

    ``fn(*args, **kwargs)`` is the step the hot path dispatches; ``args``
    are its tensor inputs as pytrees of ``meta`` tensors (shapes and
    dtypes only; the checker makes fake tensors of them on the traced
    device), ``args[0]`` the params tree and ``args[batch_argnum]`` the
    device batch; ``kwargs`` are its static arguments. ``partitions`` is
    the number of shards the program runs (the mesh width of a family
    whose replicas split the batch; 1 where the port runs one device).
    ``ok`` maps accepted rule ids to their rationale."""

    __slots__ = ('name', 'fn', 'args', 'kwargs', 'batch_argnum',
                 'partitions', 'ok')

    def __init__(self, name: str, fn, args: Tuple, kwargs=None, *,
                 batch_argnum: int = 1, partitions: int = 1,
                 ok: Optional[Mapping[str, str]] = None) -> None:
        self.name = name
        self.fn = fn
        self.args = tuple(args)
        self.kwargs = dict(kwargs or {})
        self.batch_argnum = int(batch_argnum)
        self.partitions = int(partitions)
        self.ok = dict(ok or {})


@functools.lru_cache(maxsize=None)
def register_pytree_nodes() -> None:
    """Make the params trees' containers pytree nodes, so ``torch.export``
    takes them as inputs: ``ops/quant.py::QuantizedTensor`` (the int8
    lane's weights) flattens to its ``q`` and ``scale``."""
    import torch.utils._pytree as pytree

    from video_features_torch.ops.quant import QuantizedTensor
    pytree.register_pytree_node(
        QuantizedTensor,
        lambda t: ((t.q, t.scale), None),
        lambda children, _: QuantizedTensor(*children),
        flatten_with_keys_fn=lambda t: (
            ((pytree.GetAttrKey('q'), t.q),
             (pytree.GetAttrKey('scale'), t.scale)), None),
        serialized_type_name='video_features_torch.ops.quant.QuantizedTensor')


def abstract(tree):
    """``tree``'s tensors as ``meta`` tensors (shapes and dtypes only)."""
    import torch
    import torch.utils._pytree as pytree
    register_pytree_nodes()
    return pytree.tree_map(
        lambda t: torch.empty(t.shape, dtype=t.dtype, device='meta')
        if isinstance(t, torch.Tensor) else t, tree)


def sharded(fn, parts: int, batch_argnum: int = 1):
    """The port's program at mesh width ``parts``: ``fn`` on ``parts``
    contiguous shards of the global batch, outputs concatenated in shard
    order, as the port's replicas run it (``parallel/mesh.py::
    split_batch``)."""
    if parts <= 1:
        return fn

    def program(*args, **kwargs):
        import torch
        import torch.utils._pytree as pytree
        outs = []
        for shard in torch.chunk(args[batch_argnum], parts):
            call = args[:batch_argnum] + (shard,) + args[batch_argnum + 1:]
            outs.append(fn(*call, **kwargs))
        leaves, spec = zip(*(pytree.tree_flatten(o) for o in outs))
        return pytree.tree_unflatten(
            [torch.cat(col) for col in zip(*leaves)], spec[0])
    return program


class Finding:
    """One rule violation or lock drift at
    ``family/mesh<n>[@lane]/program``."""

    __slots__ = ('rule', 'family', 'mesh', 'program', 'message', 'lane')

    def __init__(self, rule: str, family: str, mesh: int, program: str,
                 message: str, lane: str = 'float32') -> None:
        self.rule = rule
        self.family = family
        self.mesh = int(mesh)
        self.program = program
        self.message = message
        self.lane = lane

    def render(self) -> str:
        lane = '' if self.lane == 'float32' else f'@{self.lane}'
        return (f'{self.family}/mesh{self.mesh}{lane}/{self.program}: '
                f'[{self.rule}] {self.message}')


# -- tracing -----------------------------------------------------------------

def _getitem(x, index):
    """``x[index]`` through the aten ops torch's own indexing records
    (select, slice, unsqueeze, then one ``index`` over the tensor
    indices), for tensors whose device has no guard in this process."""
    import torch
    if not isinstance(index, tuple):
        index = (index,)
    index = tuple(torch.tensor(i, device=x.device) if isinstance(i, list)
                  else i for i in index)
    specified = sum(
        (i.ndim if isinstance(i, torch.Tensor) and i.dtype == torch.bool
         else 1) for i in index if i is not None and i is not Ellipsis)
    out, dim, tensors = x, 0, []
    for i in index:
        if i is None:
            out = torch.ops.aten.unsqueeze.default(out, dim)
            dim += 1
        elif i is Ellipsis:
            dim += x.ndim - specified
        elif isinstance(i, slice):
            if not (i.start in (None, 0) and i.stop is None
                    and i.step in (None, 1)):
                out = torch.ops.aten.slice.Tensor(
                    out, dim, i.start, i.stop,
                    1 if i.step is None else i.step)
            dim += 1
        elif isinstance(i, torch.Tensor):
            tensors += [None] * (dim - len(tensors)) + [i]
            dim += 1
        else:
            out = torch.ops.aten.select.int(out, dim, int(i))
    if tensors:
        out = torch.ops.aten.index.Tensor(out, tensors)
    return out


def _setitem(x, index, value) -> None:
    import torch
    if not isinstance(index, tuple):
        index = (index,)
    if any(isinstance(i, (torch.Tensor, list)) for i in index):
        raise NotImplementedError('vft-programs: tensor-indexed assignment '
                                  'in a traced step')
    view = _getitem(x, index)
    if isinstance(value, torch.Tensor):
        torch.ops.aten.copy_.default(view, value)
    else:
        torch.ops.aten.fill_.Scalar(view, value)


def _traced_calls():
    """The torch-function handlers of :class:`_DeviceIndependentCalls`:
    the tensor methods whose Python bindings take a device guard, routed
    to the aten ops they dispatch to when their tensor is on a CUDA
    device. A CPU-only torch has no CUDA guard, so without them a fake
    CUDA trace fails; the card's trace takes the same routes (the rule
    reads only the tensor's device), so both record the same graph."""
    import torch
    import torch.nn.functional as F

    def grid_sample(input, grid, mode='bilinear', padding_mode='zeros',
                    align_corners=None):
        return torch.ops.aten.grid_sampler.default(
            input, grid, {'bilinear': 0, 'nearest': 1, 'bicubic': 2}[mode],
            {'zeros': 0, 'border': 1, 'reflection': 2}[padding_mode],
            bool(align_corners))

    return {
        torch.Tensor.__getitem__: _getitem,
        torch.Tensor.__setitem__: _setitem,
        torch.Tensor.contiguous: lambda x, memory_format=torch.contiguous_format:
            torch.ops.aten.contiguous.default(x, memory_format=memory_format),
        torch.Tensor.to: lambda x, *a, **k: torch.ops.aten.to(x, *a, **k),
        F.grid_sample: grid_sample,
    }


def _program_module(fn, kwargs):
    """``fn(*args, **kwargs)`` as the ``nn.Module`` ``torch.export``
    takes, its tensor-method calls routed as :func:`_traced_calls` says."""
    import torch
    from torch.overrides import TorchFunctionMode

    calls = _traced_calls()

    class _DeviceIndependentCalls(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            handler = calls.get(func)
            if handler is not None and args \
                    and isinstance(args[0], torch.Tensor) \
                    and args[0].device.type == 'cuda':
                return handler(*args, **(kwargs or {}))
            return func(*args, **(kwargs or {}))

    class Program(torch.nn.Module):
        def forward(self, *args):
            with _DeviceIndependentCalls():
                return fn(*args, **kwargs)

    return Program()


@contextlib.contextmanager
def _release_independent_tracing():
    """Trace as every build traces: a convolution's output takes the
    contiguous layout (a build picks its backend's — cuDNN's
    channels-last on the card, the slow kernel's on a CPU-only build —
    and the kernels' wrappers and every ``contiguous()`` record explicit
    nodes, so the graph does not depend on it), and ``torch.tensor(...,
    device=d)`` builds on the host and moves to ``d`` in the graph (a
    build without a CUDA device can do nothing else; one with a device
    would fold the move). Nodes carry no Python stack trace: the lock
    reads none, and recording them is half a trace's time."""
    import torch
    import torch.fx.config as fx_config
    layout = torch._C._conv_determine_backend_memory_format
    lift = torch._C._only_lift_cpu_tensors()
    traces = getattr(fx_config, 'do_not_emit_stack_traces', None)
    torch._C._conv_determine_backend_memory_format = \
        lambda input, weight, backend: torch.contiguous_format
    torch._C._set_only_lift_cpu_tensors(True)
    if traces is not None:              # a release without it records them
        fx_config.do_not_emit_stack_traces = True
    try:
        yield
    finally:
        torch._C._conv_determine_backend_memory_format = layout
        torch._C._set_only_lift_cpu_tensors(lift)
        if traces is not None:
            fx_config.do_not_emit_stack_traces = traces


def export_program(fn, args: Tuple, kwargs: Optional[Mapping] = None):
    """``torch.export.export`` of ``fn(*args, **kwargs)`` (non-strict),
    ``args`` real or fake tensors (pytrees); the exported program's
    ``module()`` runs it. On CUDA tensors the hand kernels' wrappers call
    their ``vft::`` ops, which the exported program calls in turn."""
    import torch
    with torch.no_grad(), _release_independent_tracing():
        return torch.export.export(_program_module(fn, dict(kwargs or {})),
                                   tuple(args), strict=False)


def fake_inputs(tree, device: str = DEVICE):
    """A pytree of meta (or real) tensors as fake tensors on ``device``,
    in one ``FakeTensorMode``."""
    import torch
    import torch.utils._pytree as pytree
    from torch._subclasses.fake_tensor import FakeTensorMode
    mode = FakeTensorMode()
    with _release_independent_tracing(), mode:
        return pytree.tree_map(
            lambda t: torch.empty(t.shape, dtype=t.dtype, device=device)
            if isinstance(t, torch.Tensor) else t, tree)


def _dtype_name(dtype) -> str:
    return str(dtype).replace('torch.', '')


def _aval_doc(t) -> Dict[str, Any]:
    return {'shape': [int(d) for d in t.shape], 'dtype': _dtype_name(t.dtype)}


def _param_census(tree) -> Dict[str, Dict[str, int]]:
    """dtype → {arrays, bytes} over every tensor leaf of ``tree``."""
    import torch
    import torch.utils._pytree as pytree
    census: Dict[str, Dict[str, int]] = {}
    for leaf in pytree.tree_leaves(tree):
        if not isinstance(leaf, torch.Tensor):
            continue
        rec = census.setdefault(_dtype_name(leaf.dtype),
                                {'arrays': 0, 'bytes': 0})
        rec['arrays'] += 1
        rec['bytes'] += int(leaf.numel() * leaf.element_size())
    return census


def _sorted_tree(tree):
    """``(leaves, tree text)`` with dict keys sorted, leaves in that
    order — the JAX lock's ``out``/``out_tree`` convention
    (``PyTreeDef({'flow': *, 'rgb': *})``)."""
    if isinstance(tree, dict):
        leaves, parts = [], []
        for k in sorted(tree):
            sub, text = _sorted_tree(tree[k])
            leaves += sub
            parts.append(f'{k!r}: {text}')
        return leaves, '{' + ', '.join(parts) + '}'
    if isinstance(tree, (list, tuple)):
        leaves, parts = [], []
        for v in tree:
            sub, text = _sorted_tree(v)
            leaves += sub
            parts.append(text)
        open_, close = ('[', ']') if isinstance(tree, list) else ('(', ')')
        return leaves, open_ + ', '.join(parts) + close
    return [tree], '*'


def _target_name(target) -> str:
    """``namespace.op.overload`` of an op node's target, else the
    callable's name."""
    if hasattr(target, '_overloadname'):
        return f'{target._schema.name.replace("::", ".")}.{target._overloadname}'
    return str(getattr(target, '__name__', None) or target)


def _is_bookkeeping(node) -> bool:
    name = _target_name(node.target)
    return any(name.split('.')[1:2] == [op] for op in _BOOKKEEPING_OPS)


def graph_text(ep) -> str:
    """The exported graph as normalized text: one line per node (its
    position, op, target, arguments by position, output shapes and
    dtypes), bookkeeping nodes left out; the input of
    ``graph_sha256``."""
    import torch
    from torch.fx.node import map_arg
    nodes = [n for n in ep.graph.nodes
             if not (n.op == 'call_function' and _is_bookkeeping(n))]
    index = {n: f'%{i}' for i, n in enumerate(nodes)}

    def arg(a):
        return index.get(a, '%?')

    def val(v):
        if isinstance(v, torch.Tensor):
            return f'{_dtype_name(v.dtype)}{list(v.shape)}'
        if isinstance(v, (list, tuple)):
            return '(' + ','.join(val(x) for x in v) + ')'
        return type(v).__name__
    lines = []
    for n in nodes:
        target = _target_name(n.target) if n.op == 'call_function' \
            else n.op
        lines.append(f'{index[n]} {n.op} {target} '
                     f'{map_arg(n.args, arg)!r} {map_arg(n.kwargs, arg)!r} '
                     f'-> {val(n.meta.get("val"))}')
    return '\n'.join(lines) + '\n'


def graph_sha256(ep) -> str:
    return hashlib.sha256(graph_text(ep).encode()).hexdigest()


def ops_census(ep) -> Dict[str, int]:
    """``{target: count}`` of the graph's ``call_function`` nodes."""
    counts = Counter(_target_name(n.target) for n in ep.graph.nodes
                     if n.op == 'call_function' and not _is_bookkeeping(n))
    return dict(sorted(counts.items()))


def kernel_nodes(ep) -> int:
    """The number of ``vft::`` (hand kernel) op nodes in the graph."""
    return sum(c for name, c in ops_census(ep).items()
               if name.startswith(KERNEL_NAMESPACE + '.'))


def program_signature(spec: ProgramSpec, device: str = DEVICE
                      ) -> Tuple[Dict[str, Any], Any]:
    """``(signature, exported program)`` of one spec, traced on fake
    tensors on ``device``."""
    import torch
    import torch.utils._pytree as pytree
    args = fake_inputs(spec.args, device)
    ep = export_program(sharded(spec.fn, spec.partitions, spec.batch_argnum),
                        args, spec.kwargs)
    output = next(n for n in ep.graph.nodes if n.op == 'output')
    outputs = pytree.tree_unflatten([a.meta['val'] for a in output.args[0]],
                                    ep.call_spec.out_spec)
    leaves, tree = _sorted_tree(outputs)
    const_bytes = sum(int(c.numel() * c.element_size())
                      for c in ep.constants.values()
                      if isinstance(c, torch.Tensor))
    sig: Dict[str, Any] = {
        'batch': _aval_doc(spec.args[spec.batch_argnum]),
        'params': _param_census(spec.args[0]),
        'out': [_aval_doc(v) for v in leaves],
        'out_tree': f'PyTreeDef({tree})',
        'num_partitions': spec.partitions,
        'const_bytes': const_bytes,
        'ops': ops_census(ep),
        'kernels': kernel_nodes(ep),
        'graph_sha256': graph_sha256(ep),
        'torch': torch.__version__,
    }
    return sig, ep


# -- rule checks -------------------------------------------------------------

def _f64_nodes(ep) -> List[str]:
    import torch
    bad = []
    for n in ep.graph.nodes:
        vals = n.meta.get('val')
        for v in (vals if isinstance(vals, (list, tuple)) else [vals]):
            if isinstance(v, torch.Tensor) and v.dtype in (
                    torch.float64, torch.complex128):
                bad.append(n.name)
                break
    return bad


def _host_nodes(ep) -> List[str]:
    import operator

    import torch
    bad = []
    for n in ep.graph.nodes:
        if n.op != 'call_function':
            continue
        if n.target is operator.getitem:
            continue
        if not isinstance(n.target, (torch._ops.OpOverload,
                                     torch._ops.OpOverloadPacket)):
            bad.append(f'{n.name} (a Python callable, '
                       f'{_target_name(n.target)})')
            continue
        op = _target_name(n.target).split('.')
        if op[0] == 'aten' and op[1] in _HOST_OPS:
            bad.append(f'{n.name} ({".".join(op)})')
    return bad


def check_program(spec: ProgramSpec, sig: Dict[str, Any], ep, family: str,
                  width: int, mesh, lane: str = 'float32') -> List[Finding]:
    findings: List[Finding] = []

    def report(rule: str, message: str) -> None:
        if rule not in spec.ok:
            findings.append(Finding(rule, family, width, spec.name,
                                    message, lane=lane))

    f64 = _f64_nodes(ep)
    if f64:
        report('no-f64', f'program computes in float64 at {f64[:5]} — a '
                         f'silent float64 promotion (pin float32 at the '
                         f'boundary; the card runs fp64 at 1/30 of fp32)')
    host = _host_nodes(ep)
    if host:
        report('no-host-callback',
               f'program reads data back to the host at {host[:5]} — a '
               f'hot step must never stall the stream on the Python side')
    if mesh is not None:
        from video_features_torch.parallel.mesh import shard_error
        err = shard_error(sig['batch']['shape'][0], mesh)
        if err is not None:
            report('shardable', f'batch dim not shardable at mesh width '
                                f'{width}: {err}')
    if sig['const_bytes'] > CONST_BUDGET:
        report('const-budget',
               f'program closes over {sig["const_bytes"]} bytes of '
               f'constants (budget {CONST_BUDGET}) — weights '
               f'captured by closure get baked into the graph instead of '
               f'being passed as params')
    if lane == 'bfloat16':
        leaked = sorted(dt for dt in sig['params']
                        if dt in ('float32', 'float64'))
        if leaked:
            detail = ', '.join(
                f'{dt}: {sig["params"][dt]["arrays"]} array(s) / '
                f'{sig["params"][dt]["bytes"]} bytes' for dt in leaked)
            report('bf16-census',
                   f'compute_dtype=bfloat16 program still carries {detail} '
                   f'in its parameter census — the lane cast '
                   f'(transplant.to_lane) missed them')
    if lane == 'int8':
        census = sig['params']
        if 'float64' in census:
            report('int8-census', 'compute_dtype=int8 program carries '
                                  'float64 params — no lane stores f64')
        if 'int8' not in census:
            report('int8-census', 'compute_dtype=int8 program has NO int8 '
                                  'params in its census — the weight '
                                  'quantization (ops/quant.py) never ran')
        else:
            f32 = census.get('float32', {}).get('bytes', 0)
            i8 = census['int8']['bytes']
            if f32 >= i8:
                report('int8-census',
                       f'compute_dtype=int8 program carries more float32 '
                       f'param bytes ({f32}) than int8 ({i8}) — float32 '
                       f'must be the declared minority (scales/biases/norm '
                       f'params); the quantizer missed the weights')
    return findings


# -- collection --------------------------------------------------------------

def program_mesh(width: int):
    """A data mesh of ``width`` CUDA devices (None for width 1); the
    devices are named, never touched."""
    if width <= 1:
        return None
    from video_features_torch.parallel.mesh import make_mesh
    return make_mesh(n_devices=width, time_parallel=1,
                     devices=[f'{DEVICE}:{i}' for i in range(width)])


def collect(families: Iterable[str], widths: Iterable[int],
            lanes: Iterable[str] = LANES, device: str = DEVICE,
            log=None) -> Tuple[Dict[str, Any], List[Finding]]:
    """Build each family once per lane it takes, export its programs at
    every width, run the rule checks. Returns (live lock fragment,
    findings)."""
    families = tuple(families)
    live: Dict[str, Any] = {family: {} for family in families}
    findings: List[Finding] = []
    for lane in lanes:
        for family in lane_families(lane, families):
            ex = build_family(family, compute_dtype=lane)
            for width in widths:
                mesh = program_mesh(width)
                specs = ex.program_specs(mesh=mesh)
                if not specs:
                    findings.append(Finding(
                        'coverage', family, width, '-',
                        f'{family} exposes no program specs '
                        f'(BaseExtractor.program_specs)', lane=lane))
                    continue
                progs: Dict[str, Any] = {}
                for spec in specs:
                    t0 = time.perf_counter()
                    sig, ep = program_signature(spec, device)
                    findings.extend(check_program(spec, sig, ep, family,
                                                  width, mesh, lane=lane))
                    progs[spec.name] = sig
                    if log is not None:
                        log(f'{family}/{mesh_key(width, lane)}/{spec.name}: '
                            f'{len(ep.graph.nodes)} nodes, {sig["kernels"]} '
                            f'kernel nodes, {time.perf_counter() - t0:.1f} s')
                live[family][mesh_key(width, lane)] = {'programs': progs}
            del ex
    return live, findings


# -- the lock ----------------------------------------------------------------

def default_lock_path() -> Path:
    """``analysis/PROGRAMS.lock.json`` of the installed package."""
    return Path(__file__).resolve().parent / DEFAULT_LOCK


def load_lock(path) -> Dict[str, Any]:
    path = Path(path)
    if not path.exists():
        return {}
    return json.loads(path.read_text() or '{}')


def write_lock(path, live: Dict[str, Any], *,
               prune_families: bool = False,
               replace_widths: bool = False) -> None:
    """Re-pin exactly the checked (family, key) entries and keep the
    rest; a full-scope re-pin also drops unknown families
    (``prune_families``) and replaces each family's entry wholesale
    (``replace_widths``)."""
    doc = load_lock(path)
    families = dict(doc.get('families', {}))
    if prune_families:
        families = {k: v for k, v in families.items() if k in ALL_PINNED}
    for family, fam_doc in live.items():
        if replace_widths:
            families[family] = {k: fam_doc[k] for k in sorted(fam_doc)}
            continue
        merged = dict(families.get(family, {}))
        merged.update(fam_doc)
        families[family] = {k: merged[k] for k in sorted(merged)}
    out = {'schema': LOCK_SCHEMA,
           'families': {k: families[k] for k in sorted(families)}}
    Path(path).write_text(json.dumps(out, indent=1, sort_keys=True) + '\n')


def family_lock_hashes(feature_type: str,
                       path=None) -> Dict[str, Dict[str, str]]:
    """``{mesh<n>[@lane]: {program: graph_sha256}}`` for one family from
    the committed lock — pure stdlib, safe from any process. ``{}`` when
    the lock is absent, unreadable or the family unpinned."""
    try:
        doc = load_lock(path or default_lock_path())
    except (OSError, ValueError):
        return {}
    fam = doc.get('families', {}).get(feature_type, {})
    out: Dict[str, Dict[str, str]] = {}
    for mesh, entry in fam.items():
        hashes = {name: sig.get('graph_sha256', '')
                  for name, sig in entry.get('programs', {}).items()}
        if hashes:
            out[mesh] = hashes
    return out


# fields whose drift is reported one by one; graph_sha256 is compared
# apart (release-bound)
_DIFF_FIELDS = ('batch', 'params', 'out', 'out_tree', 'num_partitions',
                'const_bytes', 'ops', 'kernels')


def diff_lock(live: Dict[str, Any], lock: Dict[str, Any],
              checked: Iterable[str],
              widths: Iterable[int] = MESH_WIDTHS,
              lanes: Iterable[str] = LANES,
              notes: Optional[List[str]] = None) -> List[Finding]:
    """Field-by-field drift between the live programs and the lock.
    Families, widths and lanes outside the checked scope are skipped; a
    lock family that is not known at all is always reported. A
    ``graph_sha256`` that differs under another torch release than the
    entry's is a note (appended to ``notes``), not a finding."""
    findings: List[Finding] = []
    lanes = tuple(lanes)
    locked = lock.get('families', {})

    def checked_meshes(family: str) -> set:
        return {mesh_key(w, lane) for w in widths for lane in lanes
                if family in lane_families(lane, (family,))}
    for family in sorted(locked):
        if family not in ALL_PINNED:
            findings.append(Finding(
                'lock-drift', family, 0, '-',
                f'lock names unknown family {family!r} — stale entry '
                f'(re-pin with --write-lock)'))
    for family in checked:
        lv = live.get(family, {})
        lk = locked.get(family)
        if lk is None:
            findings.append(Finding(
                'lock-drift', family, 0, '-',
                f'{family} is not in the lock — pin it with --write-lock'))
            continue
        for mesh in sorted((set(lv) | set(lk)) & checked_meshes(family)):
            width, lane = parse_mesh_key(mesh)
            lvp = lv.get(mesh, {}).get('programs', {})
            lkp = lk.get(mesh, {}).get('programs', {})
            for name in sorted(set(lvp) | set(lkp)):
                if name not in lkp:
                    findings.append(Finding(
                        'lock-drift', family, width, name,
                        'new program not in the lock — re-pin with '
                        '--write-lock', lane=lane))
                    continue
                if name not in lvp:
                    findings.append(Finding(
                        'lock-drift', family, width, name,
                        'pinned program no longer exported by the family '
                        '— stale lock entry (re-pin with --write-lock)',
                        lane=lane))
                    continue
                a_sig, b_sig = lkp[name], lvp[name]
                for field in _DIFF_FIELDS:
                    a, b = a_sig.get(field), b_sig.get(field)
                    if a != b:
                        findings.append(Finding(
                            'lock-drift', family, width, name,
                            f'{field} drifted: lock={_short(a)} '
                            f'live={_short(b)}', lane=lane))
                a, b = a_sig.get('graph_sha256'), b_sig.get('graph_sha256')
                if a == b:
                    continue
                where = f'{family}/{mesh}/{name}'
                if a_sig.get('torch') == b_sig.get('torch'):
                    findings.append(Finding(
                        'lock-drift', family, width, name,
                        f'graph_sha256 drifted under the same torch '
                        f'{b_sig.get("torch")}: lock={a} live={b}',
                        lane=lane))
                elif notes is not None:
                    notes.append(f'{where}: graph_sha256 differs, written '
                                 f'under torch {a_sig.get("torch")}, '
                                 f'traced under torch {b_sig.get("torch")} '
                                 f'(the graph text is the release\'s; not '
                                 f'a finding)')
    return findings


def _short(v: Any, n: int = 160) -> str:
    s = json.dumps(v, sort_keys=True) if not isinstance(v, str) else v
    return s if len(s) <= n else s[:n - 1] + '…'


def hash_matches(live: Dict[str, Any], lock: Dict[str, Any]) -> Tuple[int, int]:
    """(programs whose graph_sha256 equals the lock's, programs compared)."""
    matched = total = 0
    locked = lock.get('families', {})
    for family, fam in live.items():
        for mesh, entry in fam.items():
            pinned = locked.get(family, {}).get(mesh, {}).get('programs', {})
            for name, sig in entry.get('programs', {}).items():
                if name in pinned:
                    total += 1
                    matched += pinned[name].get('graph_sha256') == \
                        sig['graph_sha256']
    return matched, total


# -- CLI ---------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog='vft-programs',
        description='torch.export contract checker over every family\'s '
                    'step (README, port section)')
    parser.add_argument('--families', help='comma-separated subset '
                        f'(default: all — {",".join(ALL_PINNED)})')
    parser.add_argument('--mesh-widths', default='1,2',
                        help='comma-separated mesh widths (default: 1,2)')
    parser.add_argument('--lanes', default=','.join(LANES),
                        help='comma-separated compute_dtype lanes '
                        '(default: float32,bfloat16,int8; each fast lane '
                        'covers its registry opt-in set)')
    parser.add_argument('--lock', help='lock file path (default: '
                        f'video_features_torch/analysis/{DEFAULT_LOCK})')
    parser.add_argument('--write-lock', action='store_true',
                        help='re-pin: write the live signatures for the '
                        'checked families and exit 0')
    parser.add_argument('--list-rules', action='store_true')
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in RULES:
            print(rule)
        return EXIT_CLEAN

    families = tuple(args.families.split(',')) if args.families \
        else ALL_PINNED
    unknown = [f for f in families if f not in ALL_PINNED]
    if unknown:
        print(f'vft-programs: unknown families {unknown} '
              f'(known: {", ".join(ALL_PINNED)})', file=sys.stderr)
        return EXIT_ERROR
    widths = tuple(int(w) for w in args.mesh_widths.split(','))
    lanes = tuple(args.lanes.split(','))
    bad_lanes = [lane for lane in lanes if lane not in LANES]
    if bad_lanes:
        print(f'vft-programs: unknown lanes {bad_lanes} '
              f'(known: {", ".join(LANES)})', file=sys.stderr)
        return EXIT_ERROR
    lock_path = Path(args.lock) if args.lock else default_lock_path()

    def log(line: str) -> None:
        print(line, file=sys.stderr, flush=True)
    t0 = time.perf_counter()
    try:
        live, findings = collect(families, widths, lanes, log=log)
    except Exception as e:                    # noqa: BLE001 — CLI boundary
        import traceback
        traceback.print_exc()
        print(f'vft-programs: analyzer error: {e}', file=sys.stderr)
        return EXIT_ERROR

    import torch
    n_progs = sum(len(e.get('programs', {}))
                  for fam in live.values() for e in fam.values())
    if args.write_lock:
        write_lock(lock_path, live,
                   prune_families=set(families) == set(ALL_PINNED),
                   replace_widths=(set(widths) == set(MESH_WIDTHS)
                                   and set(lanes) == set(LANES)))
        print(f'vft-programs: pinned {n_progs} program signature(s) across '
              f'{len(live)} family(ies) to {lock_path} (torch '
              f'{torch.__version__})')
        for f in findings:
            print(f'(unpinnable) {f.render()}', file=sys.stderr)
        return EXIT_CLEAN

    lock = load_lock(lock_path)
    notes: List[str] = []
    findings.extend(diff_lock(live, lock, families, widths=widths,
                              lanes=lanes, notes=notes))
    for f in findings:
        print(f.render())
    for note in notes:
        print(f'note: {note}', file=sys.stderr)
    matched, total = hash_matches(live, lock)
    print(f'vft-programs: {len(findings)} finding(s) across {n_progs} '
          f'programs, {len(live)} families, mesh widths {list(widths)}, '
          f'lanes {list(lanes)}; torch {torch.__version__}; graph hashes '
          f'matched {matched}/{total}; {time.perf_counter() - t0:.1f} s',
          file=sys.stderr)
    return EXIT_FINDINGS if findings else EXIT_CLEAN


if __name__ == '__main__':
    sys.exit(main())
