"""vft-lint core: package model, findings, suppressions, baseline (port
of ``video_features_tpu/analysis/core.py``, pure stdlib).

The analyzer is deliberately **static**: it parses every module of the
package with :mod:`ast` and never imports any of them. That is what lets
it run before the test lanes, finish in seconds, and keep the one hard
guarantee the spawn-purity rule itself depends on: the analyzer process
never imports jax or torch (``__main__`` enforces it at exit).

Vocabulary:

  * :class:`Module` — one parsed source file: path, AST, source lines,
    and the ``# vft-lint: ok=<rule>`` suppressions found in it;
  * :class:`Package` — every module of one package root (plus an
    optional tests dir, which the contract-key rules read the pinned
    schema sets from);
  * :class:`Finding` — one ``file:line`` report with a stable rule id
    and a stable ``key`` (identity that survives line drift — baselines
    match on ``(rule, file, key)``, never on line numbers);
  * baseline — a JSON list of accepted finding identities. The shipped
    baseline is EMPTY: every pre-existing accepted site carries an
    inline suppression with its rationale instead, so the rationale
    lives next to the code it excuses.

Suppression syntax (same line or the immediately preceding line)::

    except Exception:  # vft-lint: ok=swallowed-exception — teardown
    # vft-lint: ok=stdout-purity — show_pred narration is a stdout surface
    print(...)

Multiple rules separate with commas: ``ok=stdout-purity,swallowed-exception``.
"""
from __future__ import annotations

import ast
import json
import re
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Set, Tuple

SUPPRESS_RE = re.compile(r'#\s*vft-lint:\s*ok=([a-z0-9_,-]+)')

# Exit-code contract shared by every analysis CLI (vft-lint, vft-wire and
# vft-programs; chip_smoke.py gates on these). EXIT_IMPURE is for the
# pure-AST analyzers only: importing jax or torch there is a
# self-violation; vft-programs NEEDS torch by design.
EXIT_CLEAN = 0        # no findings beyond baseline/lock + suppressions
EXIT_ERROR = 1        # analyzer error (unparseable file, bad flags)
EXIT_FINDINGS = 2     # at least one NEW finding / lock drift
EXIT_IMPURE = 3       # a pure-AST analyzer process imported jax or torch

# the roots a pure-AST analyzer process must never import
FORBIDDEN_ANALYZER_IMPORTS = ('jax', 'torch')

# package-relative files the rules anchor on; a fixture package only
# needs the files its planted rule reads
CONFIG_PY = 'config.py'
CACHE_KEY_PY = 'cache/key.py'
SERVE_SERVER_PY = 'serve/server.py'
SERVE_METRICS_PY = 'serve/metrics.py'
OBS_MANIFEST_PY = 'obs/manifest.py'
TRACING_PY = 'utils/tracing.py'
FARM_WORKER_PY = 'farm/worker.py'
FARM_RECIPES_PY = 'farm/recipes.py'
HOST_TRANSFORMS_PY = 'ops/host_transforms.py'
# the wire surface (vft-wire, analysis/wire.py, + the wire-literal rule):
# the loopback protocol/client and the ingress transport/routes
SERVE_PROTOCOL_PY = 'serve/protocol.py'
SERVE_CLIENT_PY = 'serve/client.py'
INGRESS_HTTP_PY = 'ingress/http.py'
INGRESS_GATEWAY_PY = 'ingress/gateway.py'


class Finding:
    """One rule violation at ``file:line``.

    ``key`` is the drift-stable identity (symbol / import / knob name)
    that baseline matching uses; ``message`` is for humans.
    """

    __slots__ = ('rule', 'file', 'line', 'key', 'message')

    def __init__(self, rule: str, file: str, line: int, key: str,
                 message: str) -> None:
        self.rule = rule
        self.file = file
        self.line = int(line)
        self.key = key
        self.message = message

    @property
    def identity(self) -> Tuple[str, str, str]:
        return (self.rule, self.file, self.key)

    def render(self, root: Optional[Path] = None) -> str:
        path = self.file if root is None else str(Path(root) / self.file)
        return f'{path}:{self.line}: [{self.rule}] {self.message}'

    def as_json(self) -> Dict[str, str]:
        return {'rule': self.rule, 'file': self.file, 'key': self.key}


class Module:
    """One parsed source file of the package."""

    def __init__(self, rel_path: str, source: str) -> None:
        self.rel_path = rel_path
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source)
        self._parents: Optional[Dict[ast.AST, ast.AST]] = None
        # line number → set of rule names suppressed there
        self.suppressions: Dict[int, Set[str]] = {}
        for i, line in enumerate(self.lines, start=1):
            m = SUPPRESS_RE.search(line)
            if m:
                self.suppressions[i] = set(m.group(1).split(','))

    def suppressed(self, rule: str, line: int) -> bool:
        """True if ``rule`` is suppressed at ``line`` — by a trailing
        comment on the line itself or anywhere in the contiguous block
        of comment-only lines directly above it (rationales usually run
        longer than one line)."""
        if rule in self.suppressions.get(line, ()):
            return True
        ln = line - 1
        while ln >= 1 and self.lines[ln - 1].lstrip().startswith('#'):
            # only comment-only lines count going up: a suppression
            # trailing unrelated code must not leak onto the next
            # statement
            if rule in self.suppressions.get(ln, ()):
                return True
            ln -= 1
        return False

    def suppressed_in(self, rule: str, first: int, last: int) -> bool:
        """Marker anywhere in ``[first, last]`` — for findings that span
        a header region (an ``except`` clause whose rationale comment
        leads the handler body)."""
        return any(rule in self.suppressions.get(ln, ())
                   for ln in range(first, last + 1))

    @property
    def parents(self) -> Dict[ast.AST, ast.AST]:
        if self._parents is None:
            self._parents = {}
            for node in ast.walk(self.tree):
                for child in ast.iter_child_nodes(node):
                    self._parents[child] = node
        return self._parents

    def scope_of(self, node: ast.AST) -> str:
        """Dotted enclosing function/class path of ``node`` (baseline
        keys anchor on this instead of line numbers, so accepted
        findings survive unrelated edits above them)."""
        names: List[str] = []
        cur: Optional[ast.AST] = node
        while cur is not None:
            cur = self.parents.get(cur)
            if isinstance(cur, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.ClassDef)):
                names.append(cur.name)
        return '.'.join(reversed(names)) or '<module>'


class Package:
    """Every parsed module under one package root.

    ``name`` is the import name the import-graph walker resolves
    absolute imports against (``video_features_torch`` for the live tree;
    fixtures and the JAX package use their own). ``tests_dir`` — when present — is where the
    contract-key rules read the pinned schema sets from.
    """

    def __init__(self, root: Path, name: str,
                 tests_dir: Optional[Path] = None) -> None:
        self.root = Path(root)
        self.name = name
        self.tests_dir = tests_dir
        self.modules: Dict[str, Module] = {}
        for path in sorted(self.root.rglob('*.py')):
            if '__pycache__' in path.parts:
                continue
            rel = path.relative_to(self.root).as_posix()
            if rel.startswith('analysis/'):
                continue          # the analyzer does not lint itself
            self.modules[rel] = Module(rel, path.read_text())

    def get(self, rel_path: str) -> Optional[Module]:
        return self.modules.get(rel_path)

    def module_name(self, rel_path: str) -> str:
        """Dotted import name of a package-relative file."""
        parts = rel_path[:-3].split('/')          # strip .py
        if parts[-1] == '__init__':
            parts = parts[:-1]
        return '.'.join([self.name] + parts)

    def rel_path_of(self, dotted: str) -> Optional[str]:
        """Inverse of :meth:`module_name` (None for external modules)."""
        if dotted == self.name:
            return '__init__.py' if '__init__.py' in self.modules else None
        prefix = self.name + '.'
        if not dotted.startswith(prefix):
            return None
        rel = dotted[len(prefix):].replace('.', '/')
        for cand in (rel + '.py', rel + '/__init__.py'):
            if cand in self.modules:
                return cand
        return None

    def parse_tests_file(self, filename: str) -> Optional[ast.Module]:
        if self.tests_dir is None:
            return None
        path = Path(self.tests_dir) / filename
        if not path.exists():
            return None
        return ast.parse(path.read_text())


def filter_suppressed(package: Package,
                      findings: Iterable[Finding]) -> List[Finding]:
    out = []
    for f in findings:
        mod = package.get(f.file)
        if mod is not None and mod.suppressed(f.rule, f.line):
            continue
        out.append(f)
    return out


# -- baseline ----------------------------------------------------------------

def load_baseline(path: Path) -> Set[Tuple[str, str, str]]:
    """Accepted finding identities. A missing file is an empty baseline
    (fail closed: every finding is new)."""
    path = Path(path)
    if not path.exists():
        return set()
    data = json.loads(path.read_text() or '[]')
    return {(d['rule'], d['file'], d['key']) for d in data}

def write_baseline(path: Path, findings: Iterable[Finding]) -> None:
    recs = sorted({f.identity for f in findings})
    doc = [{'rule': r, 'file': fl, 'key': k} for r, fl, k in recs]
    Path(path).write_text(json.dumps(doc, indent=1, sort_keys=True) + '\n')


def new_findings(findings: Iterable[Finding],
                 baseline: Set[Tuple[str, str, str]]) -> List[Finding]:
    return [f for f in findings if f.identity not in baseline]


# -- shared AST helpers ------------------------------------------------------

def callable_name(func: ast.AST) -> str:
    """Bare name of a call target: ``Name`` id or ``Attribute`` attr
    (empty for anything fancier) — the one spelling shared by the lint
    rules and the vft-wire extractor."""
    if isinstance(func, ast.Name):
        return func.id
    if isinstance(func, ast.Attribute):
        return func.attr
    return ''


def module_constants(mod: Optional['Module'],
                     types: tuple = (str, int),
                     prefix: str = '') -> Dict[str, object]:
    """Module-level ``NAME = <constant>`` assignments (bools excluded),
    optionally filtered by name prefix — the constant tables the
    wire-literal rule and vft-wire resolve references against."""
    out: Dict[str, object] = {}
    if mod is None:
        return out
    for stmt in module_level_statements(mod.tree):
        if isinstance(stmt, ast.Assign) \
                and isinstance(stmt.value, ast.Constant) \
                and isinstance(stmt.value.value, types) \
                and not isinstance(stmt.value.value, bool):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id.startswith(prefix):
                    out[t.id] = stmt.value.value
    return out


def module_level_statements(tree: ast.Module) -> Iterable[ast.stmt]:
    """Top-level statements, descending into plain ``if`` blocks (version
    gates) but not into function/class bodies."""
    for node in tree.body:
        if isinstance(node, ast.If):
            for sub in list(node.body) + list(node.orelse):
                yield sub
        else:
            yield node


def dict_literal_str_keys(node: ast.AST) -> List[str]:
    """String-constant keys of a dict literal (non-constant keys skipped)."""
    keys: List[str] = []
    if isinstance(node, ast.Dict):
        for k in node.keys:
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                keys.append(k.value)
    return keys


def str_constants_in(node: ast.AST) -> Set[str]:
    """Every string constant anywhere under ``node``."""
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def find_assignment(tree: ast.AST, name: str) -> Optional[ast.AST]:
    """The value node of the (last) module/class-level assignment or
    AnnAssign to ``name``."""
    found = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    found = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            if isinstance(node.target, ast.Name) and node.target.id == name:
                found = node.value
    return found


def find_function(tree: ast.AST, name: str) -> Optional[ast.FunctionDef]:
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and node.name == name:
            return node
    return None


def assigned_dict_keys(func: ast.AST, varname: str) -> Set[str]:
    """Keys a function statically gives dict variable ``varname``:
    ``var = {...}`` literal keys plus ``var['k'] = ...`` subscripts."""
    keys: Set[str] = set()
    for node in ast.walk(func):
        targets: List[ast.AST] = []
        value = None
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        for t in targets:
            if isinstance(t, ast.Name) and t.id == varname:
                keys.update(dict_literal_str_keys(value))
            if isinstance(t, ast.Subscript) \
                    and isinstance(t.value, ast.Name) \
                    and t.value.id == varname \
                    and isinstance(t.slice, ast.Constant) \
                    and isinstance(t.slice.value, str):
                keys.add(t.slice.value)
    return keys


def set_literal_values(node: ast.AST) -> Set[str]:
    """String members of a set/frozenset/tuple/list literal, unwrapping
    ``frozenset({...})`` / ``set([...])`` calls."""
    if isinstance(node, ast.Call) and node.args:
        fn = node.func
        name = fn.id if isinstance(fn, ast.Name) else \
            fn.attr if isinstance(fn, ast.Attribute) else ''
        if name in ('frozenset', 'set', 'tuple', 'list'):
            node = node.args[0]
    values: Set[str] = set()
    if isinstance(node, (ast.Set, ast.Tuple, ast.List)):
        for el in node.elts:
            if isinstance(el, ast.Constant) and isinstance(el.value, str):
                values.add(el.value)
    return values
