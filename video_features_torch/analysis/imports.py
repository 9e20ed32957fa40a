"""Static import-graph walker for the spawn-purity rule (port of
``video_features_tpu/analysis/imports.py``).

Builds, per module, the list of import edges with their **level**:

  * ``module`` — executed at import time (top-level statements,
    including version-gate ``if`` blocks);
  * ``function`` — executed lazily when the enclosing function runs.

The spawn closure expands along **module-level** edges transitively,
plus the **function-level** edges of the ROOT modules themselves: a
recipe's lazy helper import (``io.video``, ``extract.streaming``) runs
inside the decoder worker at decode time, so everything those modules
import at module level is part of the worker's real footprint. Deeper
function-level imports are the package's documented *gating* idiom
(``utils/tracing.torch_profiler_trace``) — they exist precisely so the
module can live in a torch-free process — and do not expand the closure.
A *violation* is a module-level import of a forbidden root (jax, flax,
torch) by any module inside the closure.

``if TYPE_CHECKING:`` blocks are skipped entirely: they never execute.
"""
from __future__ import annotations

import ast
from typing import Dict, Iterable, List, NamedTuple, Optional, Tuple

from video_features_torch.analysis.core import Module, Package


class ImportEdge(NamedTuple):
    target: str          # dotted module name as written ('jax.numpy')
    line: int
    level: str           # 'module' | 'function'


def _is_type_checking_if(node: ast.If) -> bool:
    test = node.test
    return (isinstance(test, ast.Name) and test.id == 'TYPE_CHECKING') or \
        (isinstance(test, ast.Attribute) and test.attr == 'TYPE_CHECKING')


def _resolve_relative(rel_level: int, pkg_parts: List[str],
                      sub: Optional[str]) -> Optional[str]:
    """Absolute dotted target of a relative import. ``pkg_parts`` is the
    importing module's PACKAGE path — for ``pkg/farm/__init__.py`` that
    is ``pkg.farm`` itself, for ``pkg/farm/worker.py`` it is
    ``pkg.farm`` too (Python resolves level 1 against the containing
    package in both cases; the caller computes this distinction)."""
    if rel_level - 1 > len(pkg_parts):
        return None                          # beyond the top — broken
    base = pkg_parts[:len(pkg_parts) - (rel_level - 1)]
    if sub:
        base = base + [sub]
    return '.'.join(base) if base else None


def _imports_in(body: Iterable[ast.stmt], level: str,
                edges: List[ImportEdge], pkg_parts: List[str]) -> None:
    for node in body:
        if isinstance(node, ast.Import):
            for alias in node.names:
                edges.append(ImportEdge(alias.name, node.lineno, level))
        elif isinstance(node, ast.ImportFrom):
            if node.level:
                # relative import: resolve against the module's own
                # package path — dropping it would silently shrink the
                # closure and blind the spawn-purity rule
                mod = _resolve_relative(node.level, pkg_parts,
                                        node.module)
                if mod is None:
                    continue
            else:
                mod = node.module or ''
            for alias in node.names:
                # `from pkg.a import b` may bind submodule pkg.a.b — record
                # both; the resolver keeps whichever exists
                edges.append(ImportEdge(f'{mod}.{alias.name}',
                                        node.lineno, level))
            edges.append(ImportEdge(mod, node.lineno, level))
        elif isinstance(node, ast.If):
            if _is_type_checking_if(node):
                continue
            _imports_in(node.body, level, edges, pkg_parts)
            _imports_in(node.orelse, level, edges, pkg_parts)
        elif isinstance(node, (ast.Try, ast.With)):
            for sub_body in ([node.body] +
                             ([h.body for h in node.handlers]
                              if isinstance(node, ast.Try) else []) +
                             ([node.orelse, node.finalbody]
                              if isinstance(node, ast.Try) else [])):
                _imports_in(sub_body, level, edges, pkg_parts)
        elif isinstance(node, ast.ClassDef):
            # class BODIES execute at definition time — an import there
            # runs when the module loads, so it keeps the CURRENT level
            # (methods inside the class drop to 'function' as usual)
            _imports_in(node.body, level, edges, pkg_parts)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _imports_in(node.body, 'function', edges, pkg_parts)
        elif isinstance(node, (ast.For, ast.While)):
            _imports_in(node.body, level, edges, pkg_parts)
            _imports_in(node.orelse, level, edges, pkg_parts)


def module_imports(mod: Module, package: Optional[Package] = None
                   ) -> List[ImportEdge]:
    """Import edges of one module. ``package`` supplies the package
    path relative imports resolve against; without it they are
    dropped."""
    edges: List[ImportEdge] = []
    if package is not None:
        dotted = package.module_name(mod.rel_path)
        # the path level-1 relative imports resolve against: for an
        # __init__.py that is the package ITSELF (module_name already
        # dropped the '__init__' segment); for a plain module, its
        # containing package
        if mod.rel_path.endswith('__init__.py'):
            pkg_parts = dotted.split('.')
        else:
            pkg_parts = dotted.split('.')[:-1]
    else:
        pkg_parts = []
    _imports_in(mod.tree.body, 'module', edges, pkg_parts)
    return edges


def spawn_closure(package: Package, roots: Iterable[str]
                  ) -> Dict[str, Tuple[Optional[str], int]]:
    """Transitive static import closure over intra-package edges.

    Returns ``rel_path → (importer_rel_path, line)`` provenance (roots
    map to ``(None, 0)``), so a violation deep in the graph can name the
    chain that pulled the module in.
    """
    closure: Dict[str, Tuple[Optional[str], int]] = {}
    root_set = {r for r in roots if package.get(r) is not None}
    frontier = list(root_set)
    for r in frontier:
        closure[r] = (None, 0)
    while frontier:
        rel = frontier.pop()
        mod = package.get(rel)
        if mod is None:
            continue
        for edge in module_imports(mod, package):
            if edge.level != 'module' and rel not in root_set:
                continue          # deep lazy imports are the gating idiom
            target_rel = package.rel_path_of(edge.target)
            if target_rel is not None and target_rel not in closure:
                closure[target_rel] = (rel, edge.line)
                frontier.append(target_rel)
    return closure


def chain(closure: Dict[str, Tuple[Optional[str], int]],
          rel: str) -> List[str]:
    """Provenance chain root → ... → rel for messages."""
    out = [rel]
    seen = {rel}
    while True:
        parent, _ = closure.get(out[0], (None, 0))
        if parent is None or parent in seen:
            return out
        out.insert(0, parent)
        seen.add(parent)
