"""vft-wire: static wire-contract checker over the serving API surface
(port of ``video_features_tpu/analysis/wire.py``).

vft-lint (checks.py) pins the Python-level contracts and vft-programs
(programs.py) pins the exported programs; the third contract surface is
the **wire** — what a client process on another host can say to this
one, and what it gets back. The port's daemon, gateway and client answer
the JAX package's wire, so both packages are held to ONE lock: the
repo-root ``WIRE.lock.json``. The port reads it and never writes it
(``--write-lock`` takes only another ``--lock`` path).

Pure AST, never imports the code it checks (and never jax or torch — the
same subprocess discipline as vft-lint, same ``analysis/core.py``
exit-code contract). It walks:

  * ``serve/protocol.py`` — VERSION / MAJOR, the ``CMD_*`` command
    vocabulary, ``SUBMIT_FIELDS``, ``PRIORITIES``;
  * ``serve/server.py`` ``_dispatch`` — every handled command with the
    request fields it reads and the response/error fields it writes
    (one hop into the ``self.<handler>`` methods, ``**snapshot()``
    resolved statically);
  * ``serve/client.py`` — every ``ServeClient`` method and the command
    + fields it sends;
  * ``ingress/gateway.py`` / ``http.py`` / ``live.py`` — every HTTP
    route (method, path pattern, auth requirement, tenant scoping,
    status codes, request/response fields, structured-error
    ``(status, code)`` shapes), the transport-level status vocabulary,
    and the ``vft_ingress_*`` metric families with their label sets.

The diff enforces **compatibility semantics**, not just drift: a removed
or renamed field/command/route/status code is a BREAKING change demanding
a MAJOR bump of ``protocol.VERSION``; additive changes re-pin under a
MINOR bump. Cross-layer sync rules ride along: a ``ServeClient`` method
with no server handler (or vice versa), a submit field the server would
reject, a structured error missing its ``request_id``/``tenant`` echo,
and a route or command missing from the ``docs/ingress.md`` /
``docs/serving.md`` tables are all findings.

Status codes and command names must be spelled via the shared constants
(``ingress/http.py``, ``serve/protocol.py`` ``CMD_*``) — vft-lint's
``wire-literal`` rule enforces that, which is what makes this
extraction sound: an inline literal would be invisible to it.

Suppression: ``# vft-wire: ok=<rule> — rationale`` on the finding's
line or the comment block above it (lock-drift findings are not
suppressible).
"""
from __future__ import annotations

import argparse
import ast
import json
import re
import sys
from pathlib import Path
from typing import Any, Dict, Iterable, List, Optional, Set, Tuple

from video_features_torch.analysis.core import (
    EXIT_CLEAN, EXIT_ERROR, EXIT_FINDINGS, EXIT_IMPURE,
    FORBIDDEN_ANALYZER_IMPORTS, INGRESS_GATEWAY_PY,
    INGRESS_HTTP_PY, SERVE_CLIENT_PY, SERVE_PROTOCOL_PY, SERVE_SERVER_PY,
    Finding, Module, Package, assigned_dict_keys, callable_name,
    find_assignment, find_function, module_constants, set_literal_values,
)

# the JAX package's schema: one wire, one lock for both packages
LOCK_SCHEMA = 'video_features_tpu.wire_lock/1'
DEFAULT_LOCK = 'WIRE.lock.json'               # repo-root, shared, read-only here

INGRESS_LIVE_PY = 'ingress/live.py'

RULES = ('wire-sync', 'error-echo', 'doc-sync', 'lock-drift')

# the independently re-pinnable lock sections (--scope): a subset
# --write-lock merges only the named sections; the full-scope default
# rebuilds the document (pruning stale sections/keys)
SCOPES = ('commands', 'routes', 'transport', 'metrics')

# call positions whose first argument is an HTTP status code (the same
# vocabulary the wire-literal lint rule guards)
_STATUS_CALLS = ('HttpError', 'send_json', 'send', 'start_chunked')

_SUPPRESS_RE = re.compile(r'#\s*vft-wire:\s*ok=([a-z0-9_,-]+)')

# doc tables spell routes as `GET /path` / `POST /path` in backticks
_DOC_ROUTE_RE = re.compile(r'`(?:GET|POST)\s+(/[^`\s|]*)`')


# -- small AST helpers --------------------------------------------------------

def _resolve(node: ast.AST, consts: Dict[str, Any]) -> Any:
    """Constant / Name / Attribute → value via the constant table."""
    if isinstance(node, ast.Constant):
        return node.value
    if isinstance(node, ast.Name):
        return consts.get(node.id)
    if isinstance(node, ast.Attribute):
        return consts.get(node.attr)
    return None


def _resolve_statuses(node: ast.AST, consts: Dict[str, Any]) -> List[int]:
    """Every status an expression can evaluate to (IfExp → both arms)."""
    if isinstance(node, ast.IfExp):
        return (_resolve_statuses(node.body, consts)
                + _resolve_statuses(node.orelse, consts))
    v = _resolve(node, consts)
    return [v] if isinstance(v, int) else []


def _resolve_seq(node: Optional[ast.AST],
                 consts: Dict[str, Any]) -> List[str]:
    """Resolved string members of a tuple/list literal whose elements
    may be constants or references to the module's own constants."""
    out: List[str] = []
    if isinstance(node, (ast.Tuple, ast.List)):
        for el in node.elts:
            v = _resolve(el, consts)
            if isinstance(v, str):
                out.append(v)
    return out


def _owning_class(tree: ast.AST, fn_name: str) -> Optional[ast.AST]:
    """The ClassDef whose body (directly) holds ``fn_name`` — method
    lookup must scope to it, or a same-named method on an unrelated
    class in the module wins the resolution."""
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and any(
                isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef))
                and b.name == fn_name for b in node.body):
            return node
    return None


def _self_call_closure(scope: ast.AST,
                       roots: Iterable[ast.AST]) -> List[ast.AST]:
    """Every function in ``scope`` reachable from ``roots`` through
    ``self.<name>(...)`` calls, transitively — the static scope a
    handler's statuses/fields/errors can come from."""
    fns: List[ast.AST] = []
    seen: Set[str] = set()
    frontier = list(roots)
    while frontier:
        root = frontier.pop()
        for call in ast.walk(root):
            if isinstance(call, ast.Call) \
                    and isinstance(call.func, ast.Attribute) \
                    and isinstance(call.func.value, ast.Name) \
                    and call.func.value.id == 'self' \
                    and call.func.attr not in seen:
                seen.add(call.func.attr)
                fn = find_function(scope, call.func.attr)
                if fn is not None:
                    fns.append(fn)
                    frontier.append(fn)
    return fns


def _suppressed(mod: Optional[Module], rule: str, line: int) -> bool:
    """``# vft-wire: ok=<rule>`` on the line or the contiguous comment
    block above it (the vft-lint convention, wire's own marker)."""
    if mod is None:
        return False
    lines = mod.lines

    def at(ln: int) -> bool:
        if 1 <= ln <= len(lines):
            m = _SUPPRESS_RE.search(lines[ln - 1])
            return bool(m and rule in m.group(1).split(','))
        return False

    if at(line):
        return True
    ln = line - 1
    while ln >= 1 and lines[ln - 1].lstrip().startswith('#'):
        if at(ln):
            return True
        ln -= 1
    return False


# -- loopback protocol --------------------------------------------------------

def extract_protocol(pkg: Package) -> Dict[str, Any]:
    """VERSION/MAJOR + the declared command/field vocabularies."""
    mod = pkg.get(SERVE_PROTOCOL_PY)
    if mod is None:
        return {}
    consts = module_constants(mod)
    cmds_node = find_assignment(mod.tree, 'COMMANDS')
    return {
        'consts': consts,
        'version': consts.get('VERSION'),
        'major': consts.get('MAJOR'),
        'commands': _resolve_seq(cmds_node, consts),
        'commands_line': getattr(cmds_node, 'lineno', 1),
        'submit_fields': _resolve_seq(
            find_assignment(mod.tree, 'SUBMIT_FIELDS'), consts),
        'priorities': _resolve_seq(
            find_assignment(mod.tree, 'PRIORITIES'), consts),
    }


def _ok_error_fields(nodes: Iterable[ast.AST],
                     tree: ast.AST) -> Tuple[Set[str], Set[str]]:
    """Response/error field names written via ``protocol.ok(...)`` /
    ``protocol.error(...)`` across ``nodes``. ``**x.snapshot()`` spreads
    resolve against ``def snapshot`` in ``tree`` (the ``out`` dict)."""
    ok_fields: Set[str] = set()
    err_fields: Set[str] = set()
    for root in nodes:
        for node in ast.walk(root):
            if not isinstance(node, ast.Call):
                continue
            name = callable_name(node.func)
            if name not in ('ok', 'error'):
                continue
            if name == 'ok':
                dest = ok_fields
                dest.add('ok')
            else:
                dest = err_fields
                dest |= {'ok', 'error'}
            for kw in node.keywords:
                if kw.arg is not None:
                    dest.add(kw.arg)
                elif isinstance(kw.value, ast.Call) \
                        and callable_name(kw.value.func) == 'snapshot':
                    fn = find_function(tree, 'snapshot')
                    if fn is not None:
                        dest |= assigned_dict_keys(fn, 'out')
    return ok_fields, err_fields


def extract_server_commands(pkg: Package,
                            proto: Dict[str, Any]) -> Dict[str, Any]:
    """Every command ``_dispatch`` handles: request fields read off the
    message, response/error fields written (one hop into the
    ``self.<handler>`` methods called from the branch)."""
    mod = pkg.get(SERVE_SERVER_PY)
    if mod is None:
        return {}
    dispatch = find_function(mod.tree, '_dispatch')
    if dispatch is None:
        return {}
    consts = proto.get('consts', {})
    scope = _owning_class(mod.tree, '_dispatch') or mod.tree
    out: Dict[str, Any] = {}
    for node in ast.walk(dispatch):
        if not isinstance(node, ast.If):
            continue
        cmd = _cmd_of_test(node.test, consts)
        if cmd is None:
            continue
        # the branch plus everything it reaches via self.<handler>()
        # calls, scoped to the dispatching class (a same-named method
        # on another class in the file must not win the lookup)
        scan: List[ast.AST] = list(node.body) \
            + _self_call_closure(scope, node.body)
        req_fields: Set[str] = set()
        uses_submit_fields = False
        for root in node.body:
            for sub in ast.walk(root):
                if isinstance(sub, ast.Call) \
                        and isinstance(sub.func, ast.Attribute) \
                        and sub.func.attr == 'get' \
                        and isinstance(sub.func.value, ast.Name) \
                        and sub.func.value.id == 'msg' \
                        and sub.args \
                        and isinstance(sub.args[0], ast.Constant):
                    req_fields.add(sub.args[0].value)
                if isinstance(sub, (ast.Name, ast.Attribute)):
                    ident = sub.id if isinstance(sub, ast.Name) else sub.attr
                    if ident == 'SUBMIT_FIELDS':
                        uses_submit_fields = True
        if uses_submit_fields:
            req_fields |= set(proto.get('submit_fields', ()))
        req_fields.discard('cmd')
        ok_fields, err_fields = _ok_error_fields(scan, mod.tree)
        out[cmd] = {
            'line': node.lineno,
            'request_fields': sorted(req_fields),
            'response_fields': sorted(ok_fields),
            'error_fields': sorted(err_fields),
        }
    return out


def _cmd_of_test(test: ast.AST, consts: Dict[str, Any]) -> Optional[str]:
    """``cmd == <CMD_* | 'literal'>`` comparison → the command name."""
    if not (isinstance(test, ast.Compare) and len(test.ops) == 1
            and isinstance(test.ops[0], ast.Eq)):
        return None
    sides = [test.left, test.comparators[0]]
    idents = {s.id for s in sides if isinstance(s, ast.Name)}
    idents |= {s.attr for s in sides if isinstance(s, ast.Attribute)
               if s.attr not in consts}
    if 'cmd' not in idents:
        return None
    for s in sides:
        v = _resolve(s, consts)
        if isinstance(v, str):
            return v
    return None


def extract_client(pkg: Package,
                   proto: Dict[str, Any]) -> Dict[str, Any]:
    """``ServeClient`` surface: command → the methods that speak it and
    the request fields they set (dict-literal keys + subscript assigns
    on the message variable + ``_call``-level ``setdefault`` fields)."""
    mod = pkg.get(SERVE_CLIENT_PY)
    if mod is None:
        return {}
    consts = proto.get('consts', {})
    common: Set[str] = set()
    call_fn = find_function(mod.tree, '_call')
    if call_fn is not None:
        for node in ast.walk(call_fn):
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == 'setdefault' \
                    and node.args \
                    and isinstance(node.args[0], ast.Constant):
                common.add(node.args[0].value)
    out: Dict[str, Any] = {}
    for cls in ast.walk(mod.tree):
        if not isinstance(cls, ast.ClassDef):
            continue
        for fn in cls.body:
            if not isinstance(fn, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    or fn.name.startswith('_'):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, ast.Dict):
                    continue
                cmd = None
                fields: Set[str] = set()
                for k, v in zip(node.keys, node.values):
                    if not isinstance(k, ast.Constant):
                        continue
                    fields.add(k.value)
                    if k.value == 'cmd':
                        cmd = _resolve(v, consts)
                if cmd is None:
                    continue
                # subscript assigns on the variable the dict landed in
                for stmt in ast.walk(fn):
                    target = None
                    if isinstance(stmt, ast.Assign) \
                            and stmt.value is node:
                        target = stmt.targets[0]
                    elif isinstance(stmt, ast.AnnAssign) \
                            and stmt.value is node:
                        target = stmt.target
                    if isinstance(target, ast.Name):
                        fields |= assigned_dict_keys(fn, target.id)
                entry = out.setdefault(
                    cmd, {'client_methods': [], 'fields': set(),
                          'line': node.lineno})
                if fn.name not in entry['client_methods']:
                    entry['client_methods'].append(fn.name)
                entry['fields'] |= fields | common
    for entry in out.values():
        entry['client_methods'].sort()
        entry['fields'] = sorted(entry['fields'])
    return out


# -- ingress routes -----------------------------------------------------------

def _route_conditions(test: ast.AST) -> Dict[str, str]:
    """Parse one route test into ``{eq|prefix|suffix|method: literal}``.
    Conditions anchor on the ``path``/``method`` locals (or
    ``req.path``/``req.method`` attributes)."""
    conds: Dict[str, str] = {}
    parts = test.values if isinstance(test, ast.BoolOp) else [test]
    for part in parts:
        if isinstance(part, ast.Compare) and len(part.ops) == 1 \
                and isinstance(part.ops[0], ast.Eq):
            sides = [part.left, part.comparators[0]]
            names = {s.id for s in sides if isinstance(s, ast.Name)}
            names |= {s.attr for s in sides
                      if isinstance(s, ast.Attribute)}
            lit = next((s.value for s in sides
                        if isinstance(s, ast.Constant)
                        and isinstance(s.value, str)), None)
            if lit is None:
                continue
            if 'path' in names:
                conds['eq'] = lit
            elif 'method' in names:
                conds['method'] = lit
        elif isinstance(part, ast.Call) \
                and isinstance(part.func, ast.Attribute) \
                and part.func.attr in ('startswith', 'endswith') \
                and part.args and isinstance(part.args[0], ast.Constant):
            base = part.func.value
            ident = base.id if isinstance(base, ast.Name) else \
                base.attr if isinstance(base, ast.Attribute) else ''
            if ident == 'path':
                key = 'prefix' if part.func.attr == 'startswith' \
                    else 'suffix'
                conds[key] = part.args[0].value
    return conds


def _route_pattern(conds: Dict[str, str]) -> Optional[str]:
    if 'eq' in conds:
        return conds['eq']
    if 'prefix' in conds:
        return conds['prefix'] + '<id>' + conds.get('suffix', '')
    return None


def _scan_route(pkg: Package, gw: Module, branch: List[ast.stmt],
                status_consts: Dict[str, Any]) -> Dict[str, Any]:
    """One route branch's surface: statuses, errors, fields, scoping —
    the branch body plus one hop into ``self.<helper>`` methods."""
    handler_fns = _self_call_closure(gw.tree, branch)
    scan: List[ast.AST] = list(branch) + handler_fns
    statuses: Set[int] = set()
    errors: Set[Tuple[int, str]] = set()
    resp_fields: Set[str] = set()
    req_fields: Set[str] = set()
    tenant_scoped = False
    uses_live = False
    for root in scan:
        for node in ast.walk(root):
            # tenant scoping = an owner LOOKUP (self._owners.get(...)):
            # routes that merely record ownership (_own's writes) serve
            # any authenticated tenant and are not scoped reads
            if isinstance(node, ast.Call) \
                    and isinstance(node.func, ast.Attribute) \
                    and node.func.attr == 'get' \
                    and isinstance(node.func.value, ast.Attribute) \
                    and node.func.value.attr == '_owners':
                tenant_scoped = True
            if isinstance(node, ast.Name) and node.id == 'LiveSession':
                uses_live = True
            if isinstance(node, ast.Name) \
                    and node.id.endswith('_FIELDS'):
                fields_node = find_assignment(gw.tree, node.id)
                if fields_node is not None:
                    req_fields |= set_literal_values(fields_node)
            if not isinstance(node, ast.Call):
                continue
            name = callable_name(node.func)
            if name in _STATUS_CALLS and node.args:
                got = _resolve_statuses(node.args[0], status_consts)
                statuses.update(got)
                if name == 'HttpError' and len(node.args) >= 2 \
                        and isinstance(node.args[1], ast.Constant):
                    for st in got:
                        errors.add((st, node.args[1].value))
                if name == 'send_json' and len(node.args) >= 2:
                    resp_fields |= _dict_fields(node.args[1], root)
            if name == 'dumps' and node.args:
                resp_fields |= _dict_fields(node.args[0], root)
    if uses_live:
        live = pkg.get(INGRESS_LIVE_PY)
        if live is not None:
            fn = find_function(live.tree, 'send_window')
            if fn is not None:
                resp_fields |= assigned_dict_keys(fn, 'row')
    return {
        'status': sorted(statuses),
        'errors': [list(e) for e in sorted(errors)],
        'request_fields': sorted(req_fields),
        'response_fields': sorted(resp_fields),
        'tenant_scoped': tenant_scoped,
        'handlers': handler_fns,
    }


def _dict_fields(node: ast.AST, scope: ast.AST) -> Set[str]:
    """Statically visible keys of a response payload: literal dict keys
    plus (for ``**var`` spreads / ``dumps(var)``) the keys ``var`` is
    assigned within ``scope``."""
    fields: Set[str] = set()
    if isinstance(node, ast.Dict):
        for k, v in zip(node.keys, node.values):
            if isinstance(k, ast.Constant) and isinstance(k.value, str):
                fields.add(k.value)
            elif k is None and isinstance(v, ast.Name):
                fields |= assigned_dict_keys(scope, v.id)
    elif isinstance(node, ast.Name):
        fields |= assigned_dict_keys(scope, node.id)
    return fields


def extract_routes(pkg: Package) -> Tuple[Dict[str, Any], Set[int]]:
    """Every HTTP route off ``_handle`` (pre-auth) + ``_route`` (authed)
    → its pinned surface; plus the transport-level statuses emitted
    outside any route branch (auth gate, unknown-route fallback)."""
    gw = pkg.get(INGRESS_GATEWAY_PY)
    if gw is None:
        return {}, set()
    status_consts = module_constants(pkg.get(INGRESS_HTTP_PY))
    status_consts.update(module_constants(gw))
    routes: Dict[str, Any] = {}
    extra: Set[int] = set()
    for fn_name, authed in (('_handle', False), ('_route', True)):
        fn = find_function(gw.tree, fn_name)
        if fn is None:
            continue
        claimed: Set[int] = set()
        for node in ast.walk(fn):
            if not isinstance(node, ast.If):
                continue
            conds = _route_conditions(node.test)
            pattern = _route_pattern(conds)
            if pattern is None:
                continue
            method = conds.get('method', '*')
            info = _scan_route(pkg, gw, node.body, status_consts)
            handlers = info.pop('handlers')
            info = {'auth': authed, 'line': node.lineno, **info}
            routes[f'{method} {pattern}'] = info
            for sub in node.body:
                claimed.update(id(n) for n in ast.walk(sub))
            for h in handlers:
                claimed.update(id(n) for n in ast.walk(h))
        # statuses emitted in this function OUTSIDE any route branch:
        # the auth 401, the no-route 404/405 fallback
        for node in ast.walk(fn):
            if id(node) in claimed or not isinstance(node, ast.Call):
                continue
            if callable_name(node.func) in _STATUS_CALLS and node.args:
                extra.update(_resolve_statuses(node.args[0],
                                               status_consts))
    return routes, extra


def extract_transport(pkg: Package) -> Set[int]:
    """The transport layer's own status vocabulary (``ingress/http.py``):
    framing rejections, the handler-crash 500, the raw-bytes 503 shed
    (found by scanning bytes literals for the status line)."""
    mod = pkg.get(INGRESS_HTTP_PY)
    if mod is None:
        return set()
    consts = module_constants(mod)
    codes: Set[int] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.Call) \
                and callable_name(node.func) in _STATUS_CALLS and node.args:
            codes.update(_resolve_statuses(node.args[0], consts))
        if isinstance(node, ast.Constant) and isinstance(node.value, bytes):
            m = re.search(rb'HTTP/1\.1 (\d{3})', node.value)
            if m:
                codes.add(int(m.group(1)))
    return codes


def extract_metrics(pkg: Package) -> Dict[str, List[str]]:
    """``vft_ingress_*`` metric families registered by the gateway,
    with their label sets — per-endpoint cardinality is wire surface
    (dashboards and alerts key on these label names)."""
    gw = pkg.get(INGRESS_GATEWAY_PY)
    fams: Dict[str, List[str]] = {}
    if gw is None:
        return fams
    for node in ast.walk(gw.tree):
        if not (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr in ('counter', 'gauge', 'histogram')
                and node.args and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and node.args[0].value.startswith('vft_')):
            continue
        labels: List[str] = []
        for kw in node.keywords:
            if kw.arg == 'labels' and isinstance(kw.value, ast.Dict):
                labels = sorted(k.value for k in kw.value.keys
                                if isinstance(k, ast.Constant))
        fams[node.args[0].value] = labels
    return fams


# -- the assembled surface ----------------------------------------------------

def extract_surface(pkg: Package) -> Dict[str, Any]:
    proto = extract_protocol(pkg)
    server = extract_server_commands(pkg, proto)
    client = extract_client(pkg, proto)
    routes, extra_codes = extract_routes(pkg)
    commands: Dict[str, Any] = {}
    for cmd in sorted(set(server) | set(client)):
        sv = server.get(cmd, {})
        commands[cmd] = {
            'client_methods': client.get(cmd, {}).get('client_methods',
                                                      []),
            'request_fields': sv.get('request_fields', []),
            'response_fields': sv.get('response_fields', []),
            'error_fields': sv.get('error_fields', []),
        }
    lock_routes = {
        key: {k: v for k, v in info.items() if k != 'line'}
        for key, info in sorted(routes.items())
    }
    return {
        'schema': LOCK_SCHEMA,
        'version': proto.get('version'),
        'commands': commands,
        'routes': lock_routes,
        'transport': {
            'status': sorted(extract_transport(pkg) | extra_codes)},
        'metrics': extract_metrics(pkg),
        # extraction context the rules use (not written to the lock)
        '_proto': proto,
        '_server': server,
        '_client': client,
        '_route_lines': {k: v['line'] for k, v in routes.items()},
    }


def lock_view(surface: Dict[str, Any]) -> Dict[str, Any]:
    return {k: v for k, v in surface.items() if not k.startswith('_')}


# -- cross-layer sync rules ---------------------------------------------------

def check_sync(pkg: Package, surface: Dict[str, Any]) -> List[Finding]:
    """Client ↔ dispatch ↔ declared-COMMANDS agreement, both ways, and
    client submit fields the server's strict check would reject."""
    findings: List[Finding] = []
    proto, server, client = (surface['_proto'], surface['_server'],
                             surface['_client'])
    declared = set(proto.get('commands', ()))
    handled = set(server)
    spoken = set(client)
    line = proto.get('commands_line', 1)
    for cmd in sorted(declared - handled):
        findings.append(Finding(
            'wire-sync', SERVE_PROTOCOL_PY, line, f'undispatched:{cmd}',
            f'protocol.COMMANDS declares {cmd!r} but server _dispatch '
            f'has no handler branch for it'))
    for cmd in sorted(handled - declared):
        findings.append(Finding(
            'wire-sync', SERVE_SERVER_PY, server[cmd]['line'],
            f'undeclared:{cmd}',
            f'_dispatch handles {cmd!r} but protocol.COMMANDS does not '
            f'declare it — the documented vocabulary drifted'))
    for cmd in sorted(spoken - handled):
        findings.append(Finding(
            'wire-sync', SERVE_CLIENT_PY, client[cmd]['line'],
            f'client-only:{cmd}',
            f'ServeClient sends {cmd!r} but the server dispatch has no '
            f'handler — an old server answers "unknown cmd"'))
    for cmd in sorted(handled - spoken):
        findings.append(Finding(
            'wire-sync', SERVE_SERVER_PY, server[cmd]['line'],
            f'server-only:{cmd}',
            f'server handles {cmd!r} but no ServeClient method speaks '
            f'it — the reference client must cover the whole surface'))
    submit_ok = set(proto.get('submit_fields', ()))
    if submit_ok and 'submit' in client:
        for field in sorted(set(client['submit']['fields']) - submit_ok):
            findings.append(Finding(
                'wire-sync', SERVE_CLIENT_PY, client['submit']['line'],
                f'submit-field:{field}',
                f'ServeClient.submit sets field {field!r}, which is not '
                f'in protocol.SUBMIT_FIELDS — the server strict-rejects '
                f'the whole message'))
    return _filter(pkg, findings)


def check_error_echo(pkg: Package,
                     surface: Dict[str, Any]) -> List[Finding]:
    """Structured rejections must be correlatable: ``check_version``'s
    errors echo ``request_id``; tenant-scoped route errors carry
    ``tenant`` and ``request_id``."""
    findings: List[Finding] = []
    proto_mod = pkg.get(SERVE_PROTOCOL_PY)
    if proto_mod is not None:
        fn = find_function(proto_mod.tree, 'check_version')
        if fn is not None:
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and callable_name(node.func) == 'error' \
                        and not any(kw.arg == 'request_id'
                                    for kw in node.keywords):
                    findings.append(Finding(
                        'error-echo', SERVE_PROTOCOL_PY, node.lineno,
                        'check_version:request_id',
                        'check_version rejection does not echo '
                        'request_id — a multiplexing client cannot '
                        'correlate the failure'))
    gw = pkg.get(INGRESS_GATEWAY_PY)
    if gw is not None:
        for key, info in surface['routes'].items():
            if not info.get('tenant_scoped'):
                continue
            for root in _route_handler_fns(pkg, gw, key):
                for node in ast.walk(root):
                    if not (isinstance(node, ast.Call)
                            and callable_name(node.func) == 'HttpError'):
                        continue
                    kwargs = {kw.arg for kw in node.keywords}
                    for need in ('tenant', 'request_id'):
                        if need not in kwargs:
                            findings.append(Finding(
                                'error-echo', INGRESS_GATEWAY_PY,
                                node.lineno,
                                f'route:{key}:{need}',
                                f'structured error on tenant-scoped '
                                f'route {key} does not carry '
                                f'{need!r} — cross-host correlation '
                                f'needs the echo'))
    return _filter(pkg, findings)


def _route_handler_fns(pkg: Package, gw: Module,
                       key: str) -> List[ast.AST]:
    """The handler functions a route branch calls (re-derived so the
    error-echo rule scans the same scope the extractor pinned)."""
    for fn_name in ('_handle', '_route'):
        fn = find_function(gw.tree, fn_name)
        if fn is None:
            continue
        for node in ast.walk(fn):
            if not isinstance(node, ast.If):
                continue
            conds = _route_conditions(node.test)
            pattern = _route_pattern(conds)
            if pattern is None:
                continue
            if f"{conds.get('method', '*')} {pattern}" != key:
                continue
            return list(node.body) + _self_call_closure(gw.tree,
                                                        node.body)
    return []


def check_docs(pkg: Package, surface: Dict[str, Any],
               docs_dir: Optional[Path]) -> List[Finding]:
    """Route/command tables in docs/ingress.md + docs/serving.md must
    match the extracted surface: an extracted route/command absent from
    the docs — or a documented route that no longer exists — is drift
    between what operators read and what the wire speaks."""
    findings: List[Finding] = []
    if docs_dir is None or not Path(docs_dir).is_dir():
        return findings

    def norm(p: str) -> str:
        return re.sub(r'<[^>]+>', '<*>', p.rstrip('/'))

    ingress_md = Path(docs_dir) / 'ingress.md'
    if ingress_md.exists():
        text = ingress_md.read_text()
        documented = {norm(m) for m in _DOC_ROUTE_RE.findall(text)}
        extracted = {norm(key.split(' ', 1)[1]): key
                     for key in surface['routes']}
        for path in sorted(set(extracted) - documented):
            key = extracted[path]
            findings.append(Finding(
                'doc-sync', INGRESS_GATEWAY_PY,
                surface['_route_lines'].get(key, 1), f'route:{key}',
                f'route {key} is not in the docs/ingress.md endpoint '
                f'table — document it in the same change'))
        for path in sorted(documented - set(extracted)):
            findings.append(Finding(
                'doc-sync', INGRESS_GATEWAY_PY, 1, f'stale-route:{path}',
                f'docs/ingress.md documents route {path!r}, which the '
                f'gateway no longer serves — stale docs'))
    serving_md = Path(docs_dir) / 'serving.md'
    if serving_md.exists():
        text = serving_md.read_text()
        for cmd in sorted(surface['commands']):
            if f'`{cmd}`' in text or f'"cmd":"{cmd}"' in text \
                    or f'"cmd": "{cmd}"' in text:
                continue
            findings.append(Finding(
                'doc-sync', SERVE_PROTOCOL_PY,
                surface['_proto'].get('commands_line', 1),
                f'command:{cmd}',
                f'loopback command {cmd!r} is not named in '
                f'docs/serving.md — document it in the same change'))
    return _filter(pkg, findings)


def _filter(pkg: Package, findings: List[Finding]) -> List[Finding]:
    return [f for f in findings
            if not _suppressed(pkg.get(f.file), f.rule, f.line)]


# -- the lock -----------------------------------------------------------------

def default_lock_path() -> Path:
    return Path(__file__).resolve().parent.parent.parent / DEFAULT_LOCK


def is_shared_lock(path) -> bool:
    """True for the repo-root ``WIRE.lock.json`` the port shares with the
    JAX package (the one file :func:`write_lock` refuses)."""
    return Path(path).resolve() == default_lock_path()


def load_lock(path) -> Dict[str, Any]:
    path = Path(path)
    if not path.exists():
        return {}
    return json.loads(path.read_text() or '{}')


def write_lock(path, surface: Dict[str, Any],
               scopes: Iterable[str] = SCOPES) -> None:
    """Re-pin. A ``--scope`` subset replaces exactly the named sections
    and keeps the others from the existing lock; the full-scope default
    rebuilds the document, pruning stale sections."""
    if is_shared_lock(path):
        raise ValueError(f'{path} is the wire lock shared with the JAX '
                         f'package; the port never writes it')
    scopes = tuple(scopes)
    doc = {} if set(scopes) == set(SCOPES) else load_lock(path)
    for scope in scopes:
        doc[scope] = surface[scope]
    doc['schema'] = LOCK_SCHEMA
    doc['version'] = surface['version']
    ordered = {k: doc[k] for k in ('schema', 'version', *SCOPES)
               if k in doc}
    Path(path).write_text(
        json.dumps(ordered, indent=1, sort_keys=True) + '\n')


def _parse_version(v: Any) -> Tuple[int, int]:
    try:
        major, minor = str(v).split('.', 1)
        return int(major), int(minor)
    except (TypeError, ValueError):
        return (0, 0)


def _advice(removal: bool, live_v: Any, lock_v: Any) -> str:
    lv, kv = _parse_version(live_v), _parse_version(lock_v)
    if removal:
        if lv[0] > kv[0]:
            return (f'breaking change already under the v{lv[0]} MAJOR '
                    f'bump — re-pin with --write-lock')
        return (f'BREAKING: requires a MAJOR bump of protocol.VERSION '
                f'({lock_v} -> {kv[0] + 1}.0) plus a --write-lock '
                f're-pin')
    if lv > kv:
        return 're-pin with --write-lock (MINOR bump already taken)'
    return (f'additive: requires a MINOR bump of protocol.VERSION '
            f'({lock_v} -> {kv[0]}.{kv[1] + 1}) plus a --write-lock '
            f're-pin')


def _diff_sets(findings: List[Finding], file: str, what: str,
               live: Iterable, locked: Iterable,
               live_v: Any, lock_v: Any) -> None:
    live_s, lock_s = set(live), set(locked)
    for item in sorted(lock_s - live_s, key=str):
        findings.append(Finding(
            'lock-drift', file, 0, f'{what}:-{item}',
            f'{what} {item!r} was removed from the wire — '
            f'{_advice(True, live_v, lock_v)}'))
    for item in sorted(live_s - lock_s, key=str):
        findings.append(Finding(
            'lock-drift', file, 0, f'{what}:+{item}',
            f'{what} {item!r} is new on the wire — '
            f'{_advice(False, live_v, lock_v)}'))


def diff_lock(surface: Dict[str, Any], lock: Dict[str, Any],
              scopes: Iterable[str] = SCOPES) -> List[Finding]:
    """Field-by-field drift between the live surface and the lock, with
    compatibility semantics: removals demand a MAJOR VERSION bump,
    additions a MINOR one; either way the lock re-pins via
    ``--write-lock`` so the diff is the review surface."""
    findings: List[Finding] = []
    if not lock:
        findings.append(Finding(
            'lock-drift', SERVE_PROTOCOL_PY, 0, 'lock:missing',
            f'no {DEFAULT_LOCK} — pin the wire surface with '
            f'--write-lock'))
        return findings
    live_v, lock_v = surface.get('version'), lock.get('version')
    if live_v != lock_v:
        findings.append(Finding(
            'lock-drift', SERVE_PROTOCOL_PY, 0,
            f'version:{lock_v}->{live_v}',
            f'protocol.VERSION is {live_v!r} but the lock pins '
            f'{lock_v!r} — re-pin with --write-lock'))
    scopes = set(scopes)
    if 'commands' in scopes:
        live_c, lock_c = surface['commands'], lock.get('commands', {})
        _diff_sets(findings, SERVE_PROTOCOL_PY, 'command',
                   live_c, lock_c, live_v, lock_v)
        for cmd in sorted(set(live_c) & set(lock_c)):
            for field in ('client_methods', 'request_fields',
                          'response_fields', 'error_fields'):
                _diff_sets(findings, SERVE_PROTOCOL_PY,
                           f'command {cmd} {field.replace("_", " ")}',
                           live_c[cmd].get(field, []),
                           lock_c[cmd].get(field, []), live_v, lock_v)
    if 'routes' in scopes:
        live_r, lock_r = surface['routes'], lock.get('routes', {})
        _diff_sets(findings, INGRESS_GATEWAY_PY, 'route',
                   live_r, lock_r, live_v, lock_v)
        for key in sorted(set(live_r) & set(lock_r)):
            for flag in ('auth', 'tenant_scoped'):
                if live_r[key].get(flag) != lock_r[key].get(flag):
                    findings.append(Finding(
                        'lock-drift', INGRESS_GATEWAY_PY, 0,
                        f'route {key}:{flag}',
                        f'route {key} changed {flag}: '
                        f'lock={lock_r[key].get(flag)} '
                        f'live={live_r[key].get(flag)} — '
                        f'{_advice(True, live_v, lock_v)}'))
            for field in ('status', 'request_fields', 'response_fields'):
                _diff_sets(findings, INGRESS_GATEWAY_PY,
                           f'route {key} {field.replace("_", " ")}',
                           live_r[key].get(field, []),
                           lock_r[key].get(field, []), live_v, lock_v)
            _diff_sets(findings, INGRESS_GATEWAY_PY,
                       f'route {key} error',
                       (tuple(e) for e in live_r[key].get('errors', [])),
                       (tuple(e) for e in lock_r[key].get('errors', [])),
                       live_v, lock_v)
    if 'transport' in scopes:
        _diff_sets(findings, INGRESS_HTTP_PY, 'transport status',
                   surface['transport']['status'],
                   lock.get('transport', {}).get('status', []),
                   live_v, lock_v)
    if 'metrics' in scopes:
        live_m = surface['metrics']
        lock_m = lock.get('metrics', {})
        _diff_sets(findings, INGRESS_GATEWAY_PY, 'metric family',
                   live_m, lock_m, live_v, lock_v)
        for fam in sorted(set(live_m) & set(lock_m)):
            _diff_sets(findings, INGRESS_GATEWAY_PY,
                       f'metric {fam} label',
                       live_m[fam], lock_m[fam], live_v, lock_v)
    return findings


# -- CLI ----------------------------------------------------------------------

def run(pkg: Package, docs_dir: Optional[Path]) -> Tuple[Dict[str, Any],
                                                         List[Finding]]:
    surface = extract_surface(pkg)
    findings = (check_sync(pkg, surface)
                + check_error_echo(pkg, surface)
                + check_docs(pkg, surface, docs_dir))
    return surface, findings


def main(argv=None, preloaded=None) -> int:
    parser = argparse.ArgumentParser(
        prog='vft-wire',
        description='static wire-contract checker over the loopback + '
                    'ingress API surface (README, port section)')
    parser.add_argument('--root', help='package root to analyze '
                        '(default: the installed video_features_torch/)')
    parser.add_argument('--package-name', default='video_features_torch')
    parser.add_argument('--docs-dir', help='docs directory for the '
                        'doc-sync rule (default: <repo>/docs; doc-sync '
                        'is skipped when absent)')
    parser.add_argument('--lock', help='lock file path (default: '
                        f'<repo>/{DEFAULT_LOCK}, which is read-only here)')
    parser.add_argument('--write-lock', action='store_true',
                        help='re-pin: write the live surface for the '
                        'selected --scope sections to --lock (never the '
                        'shared repo-root lock) and exit 0')
    parser.add_argument('--scope', default=','.join(SCOPES),
                        help='comma-separated lock sections to check / '
                        f're-pin (default: all — {",".join(SCOPES)}); '
                        'a subset --write-lock merges, the full scope '
                        'prunes')
    parser.add_argument('--list-rules', action='store_true')
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in RULES:
            print(rule)
        return EXIT_CLEAN

    if preloaded is None:
        preloaded = {m for m in FORBIDDEN_ANALYZER_IMPORTS
                     if m in sys.modules}

    pkg_root = Path(__file__).resolve().parent.parent
    repo_root = pkg_root.parent
    docs_dir: Optional[Path] = repo_root / 'docs'
    if args.root:
        pkg_root = Path(args.root)
        docs_dir = None
    if args.docs_dir:
        docs_dir = Path(args.docs_dir)
    lock_path = Path(args.lock) if args.lock else default_lock_path()
    scopes = tuple(s.strip() for s in args.scope.split(',') if s.strip())
    unknown = set(scopes) - set(SCOPES)
    if unknown:
        print(f'vft-wire: unknown scope(s) {sorted(unknown)}; known: '
              f'{", ".join(SCOPES)}', file=sys.stderr)
        return EXIT_ERROR
    if args.write_lock and is_shared_lock(lock_path):
        print(f'vft-wire: {lock_path} is the wire lock the port shares with '
              f'the JAX package and is read-only here: pass --lock <other '
              f'path> to write one', file=sys.stderr)
        return EXIT_ERROR

    try:
        pkg = Package(pkg_root, args.package_name)
        surface, findings = run(pkg, docs_dir)
    except SyntaxError as e:
        print(f'vft-wire: parse error: {e}', file=sys.stderr)
        return EXIT_ERROR

    if args.write_lock:
        write_lock(lock_path, lock_view(surface), scopes)
        n_cmds = len(surface['commands'])
        n_routes = len(surface['routes'])
        print(f'vft-wire: pinned {n_cmds} command(s), {n_routes} '
              f'route(s) at wire v{surface["version"]} to {lock_path}')
        for f in findings:
            print(f'(unresolved) {f.render(pkg_root)}', file=sys.stderr)
        return EXIT_CLEAN

    lock = load_lock(lock_path)
    findings.extend(diff_lock(surface, lock, scopes))
    for f in findings:
        print(f.render(pkg_root))
    print(f'vft-wire: {len(findings)} finding(s) across '
          f'{len(surface["commands"])} commands, '
          f'{len(surface["routes"])} routes (wire v{surface["version"]} '
          f'vs lock v{lock.get("version")})',
          file=sys.stderr)
    # the same purity self-enforcement as vft-lint: everything above is
    # ast over source text — jax or torch appearing mid-run is a bug
    late = [m for m in FORBIDDEN_ANALYZER_IMPORTS
            if m in sys.modules and m not in preloaded]
    if late:
        print(f'vft-wire: FATAL: the analyzer process imported '
              f'{", ".join(late)}', file=sys.stderr)
        return EXIT_IMPURE
    return EXIT_FINDINGS if findings else EXIT_CLEAN


if __name__ == '__main__':
    sys.exit(main())
