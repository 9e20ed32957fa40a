"""vft-lint rules: the codebase's own contracts, as checkers (port of
``video_features_tpu/analysis/checks.py``; the rule ids, keys and
messages are the JAX package's, so both analyzers report the same
finding identities on the same tree).

Every rule here enforces an invariant that is *stated* somewhere in this
repo — a docstring or a hardening note — but is otherwise enforced
nowhere mechanically. The port's anchors: a spawned decode worker
imports neither jax nor torch (``FORBIDDEN_SPAWN_IMPORTS``); knobs are
validated in ``config.py::sanity_check`` or ``check_common_keys``
(``KNOB_VALIDATORS``); the pinned contract sets are read from the port's
own ``tests/test_torch_obs.py`` first (``CONTRACTS_TEST_FILES``). Each checker returns
:class:`~video_features_torch.analysis.core.Finding` objects with a stable
rule id; suppression is per-line (``# vft-lint: ok=<rule>``) with the
rationale next to the code it excuses (see ``docs/static_analysis.md``
for the rule catalog).

Rule ids (stable — baselines and suppressions key on them):

  spawn-purity            farm worker closure must not import jax/flax/torch
  recipe-picklable        recipes are picklable by construction
  knob-classification     every injected knob is classified + validated
  knob-registry           exclusion sets derive from the one registry
  swallowed-exception     broad excepts re-raise or report via obs.events
  stdout-purity           stdout belongs to the feature stream
  contract-key-sync       export schemas match their pinned contracts
  stage-vocabulary        stage names come from the canonical STAGES
  thread-discipline       module-level mutables declare their lock
  lock-order              acyclic lock graph; no untimed blocking call
                          while a lock is held
  wire-literal            status codes / command names come from the
                          shared constants the wire lock anchors on
"""
from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set

from video_features_torch.analysis.core import (
    CACHE_KEY_PY, CONFIG_PY, FARM_RECIPES_PY, FARM_WORKER_PY,
    HOST_TRANSFORMS_PY, INGRESS_HTTP_PY, OBS_MANIFEST_PY, SERVE_CLIENT_PY,
    SERVE_METRICS_PY, SERVE_PROTOCOL_PY, SERVE_SERVER_PY,
    TRACING_PY, Finding, Module, Package, assigned_dict_keys,
    callable_name, dict_literal_str_keys, find_assignment, find_function,
    module_constants, module_level_statements, set_literal_values,
    str_constants_in,
)
from video_features_torch.analysis.imports import (
    chain, module_imports, spawn_closure,
)

# -- spawn-purity ------------------------------------------------------------

SPAWN_ROOTS = (FARM_WORKER_PY, FARM_RECIPES_PY, HOST_TRANSFORMS_PY)
FORBIDDEN_SPAWN_IMPORTS = ('jax', 'flax', 'torch')


def closure_forbidden_imports(package: Package, roots: Iterable[str],
                              rule: str, contract: str) -> List[Finding]:
    """Module-level jax/flax/torch imports anywhere in the static import
    closure of ``roots`` — shared by the spawn-purity rule and the
    analyzer's own import-chain self-check."""
    findings: List[Finding] = []
    closure = spawn_closure(package, roots)
    for rel in sorted(closure):
        mod = package.get(rel)
        if mod is None:
            continue
        for edge in module_imports(mod, package):
            if edge.level != 'module':
                continue           # gated lazy imports are the idiom
            root = edge.target.split('.')[0]
            if root in FORBIDDEN_SPAWN_IMPORTS:
                via = ' -> '.join(chain(closure, rel))
                findings.append(Finding(
                    rule, rel, edge.line, f'import:{edge.target}',
                    f'module-level import of {edge.target!r} inside the '
                    f'{contract} closure ({via})'))
    return findings


def check_spawn_purity(package: Package) -> List[Finding]:
    """The decode-farm worker contract: ``farm/worker.py``,
    ``farm/recipes.py``, and ``ops/host_transforms.py`` run in spawned
    processes whose import footprint must stay at numpy/cv2 — their
    transitive static import closure (function-level intra-package
    imports included: a recipe's lazy helper import runs in the worker
    at decode time) must never reach a module-level jax/flax/torch
    import."""
    return closure_forbidden_imports(
        package, SPAWN_ROOTS, 'spawn-purity',
        'spawn-worker (decode workers must stay jax-free — '
        'farm/worker.py contract)')


# -- recipe-picklable --------------------------------------------------------

# the shared spelling lives in analysis/core.py (vft-wire resolves call
# targets the same way)
_callable_name = callable_name


def check_recipe_picklable(package: Package) -> List[Finding]:
    """Recipes cross the spawn boundary by pickle: their FIELDS
    must be plain data. Two enforcement points: (a) ``__init__`` of any
    ``*Recipe`` class in farm/recipes.py must not create lambdas /
    nested defs / local classes (anything it binds would land in a
    field), and (b) no call site anywhere may pass a lambda into a
    ``*Recipe(...)`` constructor — transforms travel as named SPECS
    (``ops.host_transforms``), never as callables."""
    findings: List[Finding] = []
    recipes = package.get(FARM_RECIPES_PY)
    if recipes is not None:
        for node in ast.walk(recipes.tree):
            if not (isinstance(node, ast.ClassDef)
                    and node.name.endswith('Recipe')):
                continue
            init = find_function(node, '__init__')
            if init is None:
                continue
            for sub in ast.walk(init):
                if isinstance(sub, (ast.Lambda, ast.ClassDef)) or \
                        (isinstance(sub, (ast.FunctionDef,
                                          ast.AsyncFunctionDef))
                         and sub is not init):
                    findings.append(Finding(
                        'recipe-picklable', FARM_RECIPES_PY, sub.lineno,
                        f'init:{node.name}',
                        f'{node.name}.__init__ creates a '
                        f'{type(sub).__name__}: recipe fields must be '
                        f'plain picklable data (spawn contract)'))
    for rel, mod in package.modules.items():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if not _callable_name(node.func).endswith('Recipe'):
                continue
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                for sub in ast.walk(arg):
                    if isinstance(sub, ast.Lambda):
                        findings.append(Finding(
                            'recipe-picklable', rel, sub.lineno,
                            f'call:{_callable_name(node.func)}',
                            f'lambda passed into '
                            f'{_callable_name(node.func)}(...): recipe '
                            f'fields cross the spawn boundary by pickle '
                            f'— use a named transform spec'))
    return findings


# -- knob-classification -----------------------------------------------------

KNOB_CLASS_VALUES = ('neither', 'pool_only', 'fingerprint_only', 'both')
_DEFAULTS_RE = re.compile(r'^[A-Z][A-Z_]*_DEFAULTS$')
# server-level namespaces: validated wholesale by split_serve_config's /
# split_fleet_config's unknown-key rejection and never merged into
# per-request configs, so fingerprint/pool-key classification does not
# apply
_EXEMPT_DEFAULTS = ('SERVE_DEFAULTS', 'FLEET_DEFAULTS')
# the functions of config.py that validate knobs: the JAX package's
# sanity_check, and the rules every port extractor checks itself; the
# config.py functions they call (the port splits its rules into
# check_*_keys helpers) validate too (_validator_literals)
KNOB_VALIDATORS = ('sanity_check', 'check_common_keys')


def _validator_literals(tree: ast.Module) -> Set[str]:
    """String constants of every ``KNOB_VALIDATORS`` function and of the
    module-level functions they call, transitively."""
    functions = {node.name: node for node in tree.body
                 if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))}
    seen: Set[str] = set()
    frontier = [n for n in KNOB_VALIDATORS if n in functions]
    literals: Set[str] = set()
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        fn = functions[name]
        literals |= str_constants_in(fn)
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and isinstance(node.func, ast.Name) \
                    and node.func.id in functions:
                frontier.append(node.func.id)
    return literals


def _defaults_dicts(mod: Module) -> Dict[str, ast.AST]:
    out: Dict[str, ast.AST] = {}
    for node in module_level_statements(mod.tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and _DEFAULTS_RE.match(t.id):
                    out[t.id] = node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            t = node.target
            if isinstance(t, ast.Name) and _DEFAULTS_RE.match(t.id):
                out[t.id] = node.value
    return out


def check_knob_classification(package: Package) -> List[Finding]:
    """Every knob the config system injects (``*_DEFAULTS`` in
    config.py, SERVE_DEFAULTS exempt) must be (a) classified in the one
    declarative ``KNOB_CLASSIFICATION`` registry — the single source of
    truth the cache fingerprint and the serve pool key derive their
    exclusion sets from — and (b) named in a validator
    (``KNOB_VALIDATORS``: an unvalidated knob is the drift the JAX
    package re-fixed by hand four times)."""
    findings: List[Finding] = []
    cfg = package.get(CONFIG_PY)
    if cfg is None:
        return findings
    reg_node = find_assignment(cfg.tree, 'KNOB_CLASSIFICATION')
    if reg_node is None:
        findings.append(Finding(
            'knob-classification', CONFIG_PY, 1, 'registry:missing',
            'config.py must declare the KNOB_CLASSIFICATION registry '
            '(knob -> neither|pool_only|fingerprint_only|both)'))
        return findings
    registry: Dict[str, str] = {}
    if isinstance(reg_node, ast.Dict):
        for k, v in zip(reg_node.keys, reg_node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str) \
                    and isinstance(v, ast.Constant):
                registry[k.value] = v.value
                if v.value not in KNOB_CLASS_VALUES:
                    findings.append(Finding(
                        'knob-classification', CONFIG_PY, v.lineno,
                        f'class:{k.value}',
                        f'knob {k.value!r} classified as {v.value!r}; '
                        f'must be one of {KNOB_CLASS_VALUES}'))
    sanity_literals = _validator_literals(cfg.tree)
    for dict_name, node in _defaults_dicts(cfg).items():
        if dict_name in _EXEMPT_DEFAULTS:
            continue
        for key in dict_literal_str_keys(node):
            if key not in registry:
                findings.append(Finding(
                    'knob-classification', CONFIG_PY, node.lineno,
                    f'unclassified:{key}',
                    f'knob {key!r} ({dict_name}) is missing from '
                    f'KNOB_CLASSIFICATION: say whether it belongs in the '
                    f'cache fingerprint and the serve pool key'))
            if key not in sanity_literals:
                findings.append(Finding(
                    'knob-classification', CONFIG_PY, node.lineno,
                    f'unvalidated:{key}',
                    f'knob {key!r} ({dict_name}) is never named in '
                    f'sanity_check: every injected knob must be '
                    f'validated (ValueError, not assert)'))
    return findings


# -- knob-registry (single source of truth) ----------------------------------

_EXCLUDE_NAME_RE = re.compile(r'EXCLUDE')
_KNOB_CONSUMERS = (CACHE_KEY_PY, SERVE_SERVER_PY)


def check_knob_registry_single_source(package: Package) -> List[Finding]:
    """The fingerprint/pool-key exclusion sets must DERIVE from
    ``config.KNOB_CLASSIFICATION`` (``knob_exclude``), never be
    hand-maintained literals in the consumers — three hand-synced copies
    of this list drifted in four consecutive PRs."""
    findings: List[Finding] = []
    for rel in _KNOB_CONSUMERS:
        mod = package.get(rel)
        if mod is None:
            continue
        uses_registry = False
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.ImportFrom) and \
                    any(a.name == 'knob_exclude' for a in node.names):
                uses_registry = True
            if isinstance(node, ast.Call) and \
                    _callable_name(node.func) == 'knob_exclude':
                uses_registry = True
        for node in module_level_statements(mod.tree):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if not (isinstance(t, ast.Name)
                        and _EXCLUDE_NAME_RE.search(t.id)):
                    continue
                if len(set_literal_values(node.value)) >= 3:
                    findings.append(Finding(
                        'knob-registry', rel, node.lineno,
                        f'literal:{t.id}',
                        f'{t.id} is a locally-defined exclusion list; '
                        f'derive it from config.KNOB_CLASSIFICATION via '
                        f'knob_exclude() so the classification has one '
                        f'source of truth'))
        if not uses_registry:
            findings.append(Finding(
                'knob-registry', rel, 1, 'registry:unused',
                f'{rel} must derive its key-exclusion set from '
                f'config.knob_exclude()'))
    return findings


# -- swallowed-exception -----------------------------------------------------

# a handler that calls any of these (or raises) has surfaced the error;
# names cover obs.events (event, log_*), warnings.warn, and logger methods
_REPORT_CALL_NAMES = ('event', 'warn', 'warning', 'error', 'exception',
                      'critical')


def _is_broad_handler(handler: ast.ExceptHandler) -> bool:
    t = handler.type
    if t is None:
        return True
    names = []
    if isinstance(t, ast.Name):
        names = [t.id]
    elif isinstance(t, ast.Tuple):
        names = [e.id for e in t.elts if isinstance(e, ast.Name)]
    return any(n in ('Exception', 'BaseException') for n in names)


def _handler_reports(handler: ast.ExceptHandler,
                     reporting_helpers: Set[str]) -> bool:
    for node in ast.walk(handler):
        if isinstance(node, ast.Raise):
            return True
        if isinstance(node, ast.Call):
            name = _callable_name(node.func)
            if name in _REPORT_CALL_NAMES or name.startswith('log_') \
                    or name in reporting_helpers:
                return True
    return False


def _reporting_helpers(mod: Module) -> Set[str]:
    """Same-module functions whose body directly calls a report function
    (one hop of indirection: ``doom_batch`` → ``log_batch_error``)."""
    helpers: Set[str] = set()
    for node in ast.walk(mod.tree):
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        for sub in ast.walk(node):
            if isinstance(sub, ast.Call):
                name = _callable_name(sub.func)
                if name in _REPORT_CALL_NAMES or name.startswith('log_'):
                    helpers.add(node.name)
                    break
    return helpers


def check_swallowed_exceptions(package: Package) -> List[Finding]:
    """The reference repo's defining bug as a rule: a bare ``except:``
    or ``except Exception`` whose body neither re-raises nor reports
    through ``obs.events`` (or ``warnings.warn`` / a logger) is exactly
    the handler that *looks* handled while silently eating a KeyError
    for seven of eight extractors. Deliberate best-effort teardown sites
    carry an inline suppression with their rationale."""
    findings: List[Finding] = []
    for rel, mod in package.modules.items():
        helpers = _reporting_helpers(mod)
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.ExceptHandler)
                    and _is_broad_handler(node)
                    and not _handler_reports(node, helpers)):
                continue
            # the rationale comment conventionally LEADS the handler
            # body — accept a marker anywhere in the header region
            # (except-line through the first body statement)
            body_first = node.body[0].lineno if node.body else node.lineno
            if not mod.suppressed_in('swallowed-exception',
                                     node.lineno, body_first):
                findings.append(Finding(
                    'swallowed-exception', rel, node.lineno,
                    f'except:{mod.scope_of(node)}',
                    'broad except neither re-raises nor reports via '
                    'obs.events / warnings.warn — the silent-KeyError '
                    'failure mode (route it through obs.events, or '
                    'suppress with a rationale if it is best-effort '
                    'teardown)'))
    return findings


# -- stdout-purity -----------------------------------------------------------

# CLI entry points own their stdout
_STDOUT_WHITELIST = ('cli.py', '__main__.py')


def _inside_print_mode_branch(node: ast.AST,
                              parents: Dict[ast.AST, ast.AST]) -> bool:
    """True when the call sits in the BODY (not the else) of an
    ``if <...on_extraction...> == 'print'`` test — the one whitelisted
    feature-stream path."""
    cur: Optional[ast.AST] = node
    while cur is not None:
        prev, cur = cur, parents.get(cur)
        if isinstance(cur, ast.If):
            test = cur.test
            names = {n.attr for n in ast.walk(test)
                     if isinstance(n, ast.Attribute)}
            names |= {n.id for n in ast.walk(test)
                      if isinstance(n, ast.Name)}
            if 'on_extraction' in names \
                    and 'print' in str_constants_in(test) \
                    and any(prev is s or prev in ast.walk(s)
                            for s in cur.body):
                return True
    return False


def check_stdout_purity(package: Package) -> List[Finding]:
    """stdout belongs to the feature stream (``on_extraction=print``):
    a bare ``print(...)`` anywhere else interleaves with it and breaks
    downstream parsers — the reason the packing fallback warns through
    ``warnings.warn`` and error prints go through ``obs.events``.
    Allowed: CLI entry modules, ``print(..., file=...)`` (an explicit
    stream is a decision), and the on_extraction=print branch itself."""
    findings: List[Finding] = []
    for rel, mod in package.modules.items():
        if rel in _STDOUT_WHITELIST:
            continue
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == 'print'):
                continue
            if any(kw.arg == 'file' for kw in node.keywords):
                continue
            if _inside_print_mode_branch(node, mod.parents):
                continue
            findings.append(Finding(
                'stdout-purity', rel, node.lineno,
                f'print:{mod.scope_of(node)}',
                'bare print() writes to stdout, which the feature stream '
                'owns — use warnings.warn / obs.events, pass file=, or '
                'suppress with a rationale for a deliberate stdout '
                'surface'))
    return findings


# -- contract-key-sync -------------------------------------------------------

# where the pinned contract sets live, first match wins per set: the
# port's own obs tests, then the JAX package's (a tree that carries only
# the latter, as the JAX tests' fixture packages do, reads it alone)
CONTRACTS_TEST_FILES = ('test_torch_obs.py', 'test_obs.py')
_CONTRACTS_TEST_FILE = CONTRACTS_TEST_FILES[0]


def _pinned_set(package: Package, name: str) -> Optional[Set[str]]:
    for filename in CONTRACTS_TEST_FILES:
        tests_tree = package.parse_tests_file(filename)
        if tests_tree is None:
            continue
        node = find_assignment(tests_tree, name)
        if node is None:
            continue
        vals = set_literal_values(node)
        if vals:
            return vals
    return None


def _compare(rule: str, rel: str, line: int, what: str,
             built: Set[str], pinned: Set[str]) -> List[Finding]:
    findings = []
    for key in sorted(built - pinned):
        findings.append(Finding(
            rule, rel, line, f'{what}:unpinned:{key}',
            f'{what} constructs key {key!r} that the pinned contract '
            f'set (tests/{_CONTRACTS_TEST_FILE}) does not name — update '
            f'the contract in the same change'))
    for key in sorted(pinned - built):
        findings.append(Finding(
            rule, rel, line, f'{what}:stale:{key}',
            f'pinned contract key {key!r} is never constructed by '
            f'{what} — stale contract entry (or a key went missing)'))
    return findings


def check_contract_keys(package: Package) -> List[Finding]:
    """The export schemas scrapers depend on — serve metrics document,
    run manifest, tracer stage records — must match the contract sets
    pinned in tests/test_torch_obs.py *exactly*, in both directions: a key
    constructed but unpinned drifts silently; a key pinned but never
    constructed is a stale contract."""
    findings: List[Finding] = []

    metrics = package.get(SERVE_METRICS_PY)
    pinned = _pinned_set(package, 'METRICS_DOC_KEYS')
    if metrics is not None and pinned is not None:
        built: Set[str] = set()
        fn = find_function(metrics.tree, 'build_metrics')
        if fn is not None:
            built |= assigned_dict_keys(fn, 'doc')
        fn = find_function(metrics.tree, 'snapshot')
        if fn is not None:
            built |= assigned_dict_keys(fn, 'out')
        findings += _compare('contract-key-sync', SERVE_METRICS_PY, 1,
                             'serve metrics document', built, pinned)

    manifest = package.get(OBS_MANIFEST_PY)
    pinned = _pinned_set(package, 'MANIFEST_KEYS')
    if manifest is not None and pinned is not None:
        fn = find_function(manifest.tree, 'document')
        built = set()
        if fn is not None:
            for node in ast.walk(fn):
                if isinstance(node, ast.Return) \
                        and isinstance(node.value, ast.Dict):
                    built |= set(dict_literal_str_keys(node.value))
        findings += _compare('contract-key-sync', OBS_MANIFEST_PY,
                             fn.lineno if fn else 1,
                             'run manifest document', built, pinned)

    tracing = package.get(TRACING_PY)
    pinned = _pinned_set(package, 'TRACER_RECORD_KEYS')
    if tracing is not None and pinned is not None:
        fn = find_function(tracing.tree, '_stat_record')
        built = assigned_dict_keys(fn, 'rec') if fn is not None else set()
        findings += _compare('contract-key-sync', TRACING_PY,
                             fn.lineno if fn else 1,
                             'tracer stage record', built, pinned)
    return findings


# -- stage-vocabulary --------------------------------------------------------

_STAGE_METHODS = ('stage', 'wrap_iter', 'add_occupancy')


def _stage_literal(node: ast.Call) -> Optional[str]:
    if node.args and isinstance(node.args[0], ast.Constant) \
            and isinstance(node.args[0].value, str):
        return node.args[0].value
    return None


def check_stage_vocabulary(package: Package) -> List[Finding]:
    """Stage names are a shared vocabulary (``utils.tracing.STAGES``):
    dashboards key ``vft_stage_*`` families and bench ``stage_reports``
    on them. Two checks: the tuple must equal the CANONICAL_STAGES
    contract pinned in tests/test_torch_obs.py, and every literal stage name
    recorded anywhere in the package must come from it."""
    findings: List[Finding] = []
    tracing = package.get(TRACING_PY)
    if tracing is None:
        return findings
    stages_node = find_assignment(tracing.tree, 'STAGES')
    stages = set_literal_values(stages_node) if stages_node else set()
    if not stages:
        findings.append(Finding(
            'stage-vocabulary', TRACING_PY, 1, 'stages:missing',
            'utils/tracing.py must declare the canonical STAGES tuple'))
        return findings
    pinned = _pinned_set(package, 'CANONICAL_STAGES')
    if pinned is not None and pinned != stages:
        drift = sorted(stages ^ pinned)
        findings.append(Finding(
            'stage-vocabulary', TRACING_PY,
            stages_node.lineno, 'stages:contract',
            f'STAGES and the CANONICAL_STAGES contract '
            f'(tests/{_CONTRACTS_TEST_FILE}) disagree on {drift} — '
            f'renaming a stage is an intentional, test-visible event'))
    for rel, mod in package.modules.items():
        for node in ast.walk(mod.tree):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            attr = node.func.attr
            name = None
            if attr in _STAGE_METHODS:
                name = _stage_literal(node)
            elif attr == 'add' and 'tracer' in ast.unparse(node.func.value):
                name = _stage_literal(node)
            if name is not None and name not in stages:
                findings.append(Finding(
                    'stage-vocabulary', rel, node.lineno, f'stage:{name}',
                    f'stage name {name!r} is not in the canonical STAGES '
                    f'vocabulary (utils/tracing.py) — add it there (and '
                    f'to the pinned contract) or reuse an existing name'))
    return findings


# -- thread-discipline -------------------------------------------------------

_CONCURRENT_DIRS = ('serve/', 'farm/', 'ingress/')
_MUTABLE_CALLS = ('dict', 'list', 'set', 'OrderedDict', 'defaultdict',
                  'deque')
_LOCK_VALUES = ('immutable',)


def _is_mutable_container(node: ast.AST) -> bool:
    if isinstance(node, (ast.Dict, ast.List, ast.Set, ast.ListComp,
                         ast.DictComp, ast.SetComp)):
        return True
    if isinstance(node, ast.Call) \
            and _callable_name(node.func) in _MUTABLE_CALLS:
        return True
    return False


def check_thread_discipline(package: Package) -> List[Finding]:
    """Modules under serve/, farm/, ingress/ run threaded by design.
    A module-level mutable container is shared state: it must be named
    in the module's ``_LOCKED_BY`` declaration, mapping it to the
    module-level lock that guards it — or to ``'immutable'`` when it is
    a constant that is never written after import."""
    findings: List[Finding] = []
    for rel, mod in package.modules.items():
        if not rel.startswith(_CONCURRENT_DIRS):
            continue
        locked_node = find_assignment(mod.tree, '_LOCKED_BY')
        locked: Dict[str, str] = {}
        if isinstance(locked_node, ast.Dict):
            for k, v in zip(locked_node.keys, locked_node.values):
                if isinstance(k, ast.Constant) and isinstance(v, ast.Constant):
                    locked[k.value] = v.value
        module_names = set()
        for stmt in module_level_statements(mod.tree):
            if isinstance(stmt, ast.Assign):
                module_names.update(t.id for t in stmt.targets
                                    if isinstance(t, ast.Name))
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                module_names.add(stmt.target.id)
        for stmt in module_level_statements(mod.tree):
            targets: List[ast.Name] = []
            value: Optional[ast.AST] = None
            if isinstance(stmt, ast.Assign):
                targets = [t for t in stmt.targets
                           if isinstance(t, ast.Name)]
                value = stmt.value
            elif isinstance(stmt, ast.AnnAssign) \
                    and isinstance(stmt.target, ast.Name):
                targets = [stmt.target]
                value = stmt.value
            if value is None or not _is_mutable_container(value):
                continue
            for t in targets:
                name = t.id
                if name.startswith('__') or name == '_LOCKED_BY':
                    continue
                if name not in locked:
                    findings.append(Finding(
                        'thread-discipline', rel, stmt.lineno,
                        f'unlocked:{name}',
                        f'module-level mutable {name!r} in a threaded '
                        f'subsystem has no _LOCKED_BY entry — name the '
                        f"lock that guards it (or 'immutable' for a "
                        f'write-once constant)'))
                elif locked[name] not in _LOCK_VALUES \
                        and locked[name] not in module_names:
                    findings.append(Finding(
                        'thread-discipline', rel, stmt.lineno,
                        f'missing-lock:{name}',
                        f'_LOCKED_BY maps {name!r} to '
                        f'{locked[name]!r}, which is not a module-level '
                        f'name in {rel}'))
    return findings


# -- lock-order --------------------------------------------------------------

# receiver-less blocking methods: a zero-positional-arg call to one of
# these blocks until someone else makes progress. The zero-arg shape is
# the discriminator that keeps dict.get(key) / str.join(seq) /
# os.path.join(a, b) out of scope — Queue.get(), Connection.recv() and
# Thread/Process.join() are exactly the forms with no positional args.
_BLOCKING_METHODS = ('get', 'recv', 'join')
_LOCK_FACTORY_NAMES = ('Lock', 'RLock', 'Condition', 'Semaphore',
                       'BoundedSemaphore')


# 'lock'/'rlock' as the final identifier TOKEN ('_lock', 'build_lock',
# '_LIVE_LOCK', 'self._lock') — token-anchored so 'block' / 'clock' /
# '_nonblocking_guard' context managers are never mistaken for locks
_LOCK_NAME_RE = re.compile(r'(?:^|_)r?lock$')


def _lock_exprs(node: ast.With, module_locks: Set[str]) -> List[str]:
    """Unparsed context expressions of a ``with`` that are lock
    acquisitions: any KNOWN module-level lock name (``_LOCKED_BY``
    values / ``threading.Lock()`` assignments — whatever it is called),
    plus any name whose final dotted segment is a 'lock'-ending token
    (the ``self._lock`` instance idiom). ``.acquire()``-style usage is
    not the codebase idiom."""
    out = []
    for item in node.items:
        src = ast.unparse(item.context_expr)
        if src in module_locks:
            out.append(src)
        elif '(' not in src and \
                _LOCK_NAME_RE.search(src.rsplit('.', 1)[-1].lower()):
            out.append(src)
    return out


def _module_level_locks(mod: Module) -> Set[str]:
    """Module-level lock names: ``_LOCKED_BY`` values (≠ 'immutable')
    plus any module-level ``threading.Lock()``-family assignment."""
    locks: Set[str] = set()
    locked_node = find_assignment(mod.tree, '_LOCKED_BY')
    if isinstance(locked_node, ast.Dict):
        for v in locked_node.values:
            if isinstance(v, ast.Constant) and isinstance(v.value, str) \
                    and v.value not in _LOCK_VALUES:
                locks.add(v.value)
    for stmt in module_level_statements(mod.tree):
        if isinstance(stmt, ast.Assign) and isinstance(stmt.value, ast.Call):
            if _callable_name(stmt.value.func) in _LOCK_FACTORY_NAMES:
                locks.update(t.id for t in stmt.targets
                             if isinstance(t, ast.Name))
    return locks


def _is_blocking_call(node: ast.Call) -> Optional[str]:
    """The blocking method name when ``node`` is a no-timeout blocking
    call, else None. ``q.get(timeout=t)`` / ``t.join(deadline)`` /
    ``q.get(False)`` (any positional arg) pass."""
    if not isinstance(node.func, ast.Attribute):
        return None
    if node.func.attr not in _BLOCKING_METHODS or node.args:
        return None
    if any(kw.arg in ('timeout', 'block') for kw in node.keywords):
        return None
    return node.func.attr


def check_lock_order(package: Package) -> List[Finding]:
    """Deadlock statics for the threaded subsystems (serve/, farm/,
    ingress/). Two checks over the lock-acquisition structure:

      * **blocking-under-lock** — a ``Queue.get()`` /
        ``Connection.recv()`` / ``join()`` with no timeout while ANY
        lock is held (module-level locks from ``_LOCKED_BY`` /
        ``threading.Lock()`` assignments, or a ``with self._lock:``
        style instance lock) waits on another thread's progress while
        holding what that thread may need — the textbook shape of the
        stalls the farm's and the daemon's hardening fixed by hand;
      * **cycle** — the static acquisition graph (edges: lock A held
        when lock B is acquired, per ``with`` nesting; lock identity is
        (module, expression) — a syntactic approximation, see
        docs/static_analysis.md) must be acyclic: an A→B edge in one
        function and B→A in another is lock-order inversion.

    Nested ``def``/``lambda`` bodies reset the held-set (they execute
    later, not under the ``with``)."""
    findings: List[Finding] = []
    edges: Dict[tuple, Set[tuple]] = {}
    edge_sites: Dict[tuple, tuple] = {}

    for rel, mod in package.modules.items():
        if not rel.startswith(_CONCURRENT_DIRS):
            continue
        module_locks = _module_level_locks(mod)

        def lock_id(expr: str, rel=rel, module_locks=module_locks) -> tuple:
            # module-level locks get a module-scoped identity; instance
            # locks (self._lock) one per (module, expression)
            return (rel, expr if expr in module_locks else f'<{expr}>')

        class _Walker(ast.NodeVisitor):
            def __init__(self, mod=mod, rel=rel):
                self.mod, self.rel = mod, rel
                self.held: List[str] = []

            def visit_With(self, node: ast.With) -> None:
                locks = _lock_exprs(node, module_locks)
                for lk in locks:
                    for held in self.held:
                        a, b = lock_id(held), lock_id(lk)
                        if a != b:
                            edges.setdefault(a, set()).add(b)
                            edge_sites.setdefault((a, b),
                                                  (self.rel, node.lineno))
                self.held.extend(locks)
                self.generic_visit(node)
                if locks:
                    del self.held[-len(locks):]

            visit_AsyncWith = visit_With

            def visit_Call(self, node: ast.Call) -> None:
                name = _is_blocking_call(node)
                if name and self.held \
                        and not self.mod.suppressed('lock-order',
                                                    node.lineno):
                    findings.append(Finding(
                        'lock-order', self.rel, node.lineno,
                        f'blocking:{self.mod.scope_of(node)}.{name}',
                        f'{ast.unparse(node.func)}() blocks with no '
                        f'timeout while holding '
                        f'{" + ".join(self.held)} — the holder waits on '
                        f'another thread that may need the lock (add a '
                        f'timeout, or move the wait outside the lock)'))
                self.generic_visit(node)

            def _reset_scope(self, node) -> None:
                held, self.held = self.held, []
                self.generic_visit(node)
                self.held = held

            def visit_FunctionDef(self, node) -> None:
                self._reset_scope(node)

            visit_AsyncFunctionDef = visit_FunctionDef
            visit_Lambda = visit_FunctionDef

        _Walker().visit(mod.tree)

    # cycle sweep over the global acquisition graph
    def _find_cycle(start: tuple) -> Optional[List[tuple]]:
        path: List[tuple] = []
        on_path: Set[tuple] = set()
        done: Set[tuple] = set()

        def dfs(node: tuple) -> Optional[List[tuple]]:
            if node in on_path:
                return path[path.index(node):] + [node]
            if node in done:
                return None
            path.append(node)
            on_path.add(node)
            for nxt in sorted(edges.get(node, ())):
                cyc = dfs(nxt)
                if cyc is not None:
                    return cyc
            path.pop()
            on_path.discard(node)
            done.add(node)
            return None

        return dfs(start)

    reported: Set[frozenset] = set()
    for start in sorted(edges):
        cyc = _find_cycle(start)
        if cyc is None:
            continue
        ident = frozenset(cyc)
        if ident in reported:
            continue
        reported.add(ident)
        rel, line = edge_sites.get((cyc[0], cyc[1]), (cyc[0][0], 1))
        chain_txt = ' -> '.join(f'{r}:{n}' for r, n in cyc)
        findings.append(Finding(
            'lock-order', rel, line,
            f'cycle:{"|".join(sorted(n for _, n in set(cyc)))}',
            f'lock-acquisition cycle: {chain_txt} — two call paths '
            f'taking these locks in opposite orders can deadlock'))
    return findings


# -- wire-literal ------------------------------------------------------------

# call positions whose first positional argument IS an HTTP status code
_WIRE_STATUS_CALLS = ('HttpError', 'send_json', 'send', 'start_chunked')


def check_wire_literal(package: Package) -> List[Finding]:
    """The wire surface is pinned statically (``WIRE.lock.json``,
    analysis/wire.py), which only works if the surface is SPELLED in one
    place: status codes come from ``ingress/http.py``'s named constants
    and command names from ``serve/protocol.py``'s ``CMD_*`` constants.
    An inline ``404`` in a status position or an inline ``'submit'`` in
    a cmd position is invisible to the extractor — the same collapse
    the knob-registry rule already did for exclusion lists."""
    findings: List[Finding] = []
    # (a) inline ints in status positions anywhere under serve/ingress
    # (ingress/http.py itself DEFINES the vocabulary and is exempt)
    for rel, mod in package.modules.items():
        if not rel.startswith(('serve/', 'ingress/')) \
                or rel == INGRESS_HTTP_PY:
            continue
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            if _callable_name(node.func) not in _WIRE_STATUS_CALLS \
                    or not node.args:
                continue
            a0 = node.args[0]
            if isinstance(a0, ast.Constant) and isinstance(a0.value, int) \
                    and not mod.suppressed('wire-literal', node.lineno):
                findings.append(Finding(
                    'wire-literal', rel, node.lineno,
                    f'status:{a0.value}',
                    f'inline status code {a0.value} in a '
                    f'{_callable_name(node.func)}(...) call — use the '
                    f'named constant from ingress/http.py so vft-wire '
                    f'can pin the route status-code set statically'))
    # (b) inline command strings in cmd positions in the loopback
    # server/client (serve/protocol.py defines CMD_* and is exempt)
    commands = set(module_constants(package.get(SERVE_PROTOCOL_PY),
                                    types=(str,),
                                    prefix='CMD_').values())
    if not commands:
        return findings
    for rel in (SERVE_SERVER_PY, SERVE_CLIENT_PY):
        mod = package.get(rel)
        if mod is None:
            continue
        for node in ast.walk(mod.tree):
            bad: Optional[ast.Constant] = None
            if isinstance(node, ast.Compare):
                sides = [node.left] + list(node.comparators)
                names = {s.id for s in sides if isinstance(s, ast.Name)}
                names |= {s.attr for s in sides
                          if isinstance(s, ast.Attribute)}
                if 'cmd' in names:
                    for s in sides:
                        if isinstance(s, ast.Constant) \
                                and s.value in commands:
                            bad = s
            elif isinstance(node, ast.Dict):
                for k, v in zip(node.keys, node.values):
                    if isinstance(k, ast.Constant) and k.value == 'cmd' \
                            and isinstance(v, ast.Constant) \
                            and v.value in commands:
                        bad = v
            if bad is not None \
                    and not mod.suppressed('wire-literal', bad.lineno):
                findings.append(Finding(
                    'wire-literal', rel, bad.lineno,
                    f'cmd:{bad.value}',
                    f'inline command string {bad.value!r} — use '
                    f'serve/protocol.py CMD_* constants so the client, '
                    f'the dispatch, and the vft-wire lock share one '
                    f'spelling'))
    return findings


# -- registry ----------------------------------------------------------------

# the ONE rule registry: name ↔ check function pairs. ALL_CHECKS and
# RULES derive from it, so a rule-name subset (`--rules`, a gate run
# for one contract) can never silently run the wrong function — two
# hand-aligned parallel tuples would drift exactly that way.
RULE_CHECKS = (
    ('spawn-purity', check_spawn_purity),
    ('recipe-picklable', check_recipe_picklable),
    ('knob-classification', check_knob_classification),
    ('knob-registry', check_knob_registry_single_source),
    ('swallowed-exception', check_swallowed_exceptions),
    ('stdout-purity', check_stdout_purity),
    ('contract-key-sync', check_contract_keys),
    ('stage-vocabulary', check_stage_vocabulary),
    ('thread-discipline', check_thread_discipline),
    ('lock-order', check_lock_order),
    ('wire-literal', check_wire_literal),
)

ALL_CHECKS = tuple(fn for _, fn in RULE_CHECKS)

RULES = tuple(name for name, _ in RULE_CHECKS)


def run_checks(package: Package,
               checks: Iterable = ALL_CHECKS) -> List[Finding]:
    """Raw findings from every check (suppressions NOT applied; repeated
    (file, key) identities NOT yet disambiguated — use :func:`analyze`
    for the baseline-ready view)."""
    findings: List[Finding] = []
    for check in checks:
        findings.extend(check(package))
    findings.sort(key=lambda f: (f.file, f.line, f.rule, f.key))
    return findings


def _ordinal_keys(findings: List[Finding]) -> List[Finding]:
    """Disambiguate repeated (file, key) identities with a source-order
    ordinal — stable under line drift, unlike line numbers."""
    seen: Dict[tuple, int] = {}
    for f in sorted(findings, key=lambda f: (f.file, f.line)):
        n = seen.get((f.file, f.key), 0)
        seen[(f.file, f.key)] = n + 1
        if n:
            f.key = f'{f.key}#{n + 1}'
    return findings


def analyze(package: Package,
            checks: Iterable = ALL_CHECKS) -> List[Finding]:
    """The baseline-ready view: run every check, drop suppressed
    findings, THEN assign disambiguating ordinals — suppressed siblings
    must not consume ordinals, or deleting one would rename (and
    resurface) a baselined neighbor."""
    from video_features_torch.analysis.core import filter_suppressed
    return _ordinal_keys(filter_suppressed(package,
                                           run_checks(package, checks)))
