"""vft-lint CLI: ``python -m video_features_torch.analysis`` (port of
``video_features_tpu/analysis/__main__.py``, with its flags).

Exit-code contract (``chip_smoke.py`` phase 28 gates on it):

  0  no findings beyond the baseline (and beyond inline suppressions)
  1  analyzer error (unparseable file, bad flags)
  2  at least one NEW finding
  3  the analyzer process imported jax or torch (self-violation: the
     lint must run on a host with neither and never pay their startup)

There is deliberately no ``--fix``: every fix is a reviewed code change.
``--write-baseline`` exists for adopting the suite on a dirty tree; the
port ships an EMPTY baseline (``analysis/lint_baseline.json``) —
accepted sites carry inline ``# vft-lint: ok=<rule>`` suppressions with
their rationale instead.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

from video_features_torch.analysis.checks import (
    ALL_CHECKS, RULE_CHECKS, RULES, analyze, closure_forbidden_imports,
)
from video_features_torch.analysis.core import (
    EXIT_CLEAN, EXIT_ERROR, EXIT_FINDINGS, EXIT_IMPURE,
    FORBIDDEN_ANALYZER_IMPORTS, Package, load_baseline, new_findings,
    write_baseline,
)

# the shipped (empty) baseline, beside this module
DEFAULT_BASELINE = Path(__file__).resolve().parent / 'lint_baseline.json'

# The purity contract is about what the ANALYZER pulls in: a host
# process (pytest with a torch-using test module) may legitimately embed
# main() with torch already loaded — only an import that appears during
# the run is a self-violation. Under `python -m` the package __init__
# runs before this module; the static chain check below covers it.
_PRELOADED = frozenset(m for m in FORBIDDEN_ANALYZER_IMPORTS
                       if m in sys.modules)


def imported_during_run(preloaded) -> list:
    """The forbidden roots in ``sys.modules`` now that were not loaded
    before the run (``preloaded``)."""
    return [m for m in FORBIDDEN_ANALYZER_IMPORTS
            if m in sys.modules and m not in preloaded]


def _default_roots():
    pkg_root = Path(__file__).resolve().parent.parent
    repo_root = pkg_root.parent
    tests_dir = repo_root / 'tests'
    return pkg_root, tests_dir if tests_dir.is_dir() else None


def main(argv=None, preloaded=None) -> int:
    parser = argparse.ArgumentParser(
        prog='vft-lint',
        description='AST/import-graph invariant checker for '
                    'video_features_torch (README, port section)')
    parser.add_argument('--root', help='package root to analyze '
                        '(default: the installed video_features_torch/)')
    parser.add_argument('--package-name', default='video_features_torch',
                        help='import name absolute imports resolve '
                        'against (fixture trees use their own)')
    parser.add_argument('--tests-dir', help='directory holding the '
                        'pinned contract sets (default: <repo>/tests)')
    parser.add_argument('--baseline', help='accepted-findings file '
                        '(default: the shipped analysis/lint_baseline.json)')
    parser.add_argument('--write-baseline', action='store_true',
                        help='accept every current finding and exit 0')
    parser.add_argument('--fail-on-new', action='store_true',
                        help='exit 2 on findings not in the baseline '
                        '(the default behavior, spelled out)')
    parser.add_argument('--rules', help='comma-separated subset of rules '
                        'to run (default: all)')
    parser.add_argument('--list-rules', action='store_true')
    args = parser.parse_args(argv)

    if args.list_rules:
        for rule in RULES:
            print(rule)
        return EXIT_CLEAN

    pkg_root, tests_dir = _default_roots()
    if args.root:
        pkg_root = Path(args.root)
        tests_dir = None
    if args.tests_dir:
        tests_dir = Path(args.tests_dir)
    baseline_path = Path(args.baseline) if args.baseline \
        else DEFAULT_BASELINE

    checks = ALL_CHECKS
    if args.rules:
        wanted = {r.strip() for r in args.rules.split(',') if r.strip()}
        unknown = wanted - set(RULES)
        if unknown:
            print(f'vft-lint: unknown rule(s) {sorted(unknown)}; '
                  f'known: {", ".join(RULES)}', file=sys.stderr)
            return EXIT_ERROR
        checks = tuple(check for name, check in RULE_CHECKS
                       if name in wanted)

    try:
        package = Package(pkg_root, args.package_name, tests_dir=tests_dir)
        findings = analyze(package, checks)
    except SyntaxError as e:
        print(f'vft-lint: parse error: {e}', file=sys.stderr)
        return EXIT_ERROR

    if args.write_baseline:
        write_baseline(baseline_path, findings)
        print(f'vft-lint: wrote {len(findings)} accepted finding(s) to '
              f'{baseline_path}')
        return EXIT_CLEAN

    fresh = new_findings(findings, load_baseline(baseline_path))
    for f in fresh:
        print(f.render(pkg_root))
    known = len(findings) - len(fresh)
    status = (f'vft-lint: {len(fresh)} new finding(s)'
              + (f', {known} baselined' if known else '')
              + f' across {len(package.modules)} modules')
    print(status, file=sys.stderr)

    # self-enforcement: the analyzer's own purity contract, two ways.
    # (a) STATIC, preload-proof: the import chain `python -m` traverses
    # before this module runs (the package __init__) must never gain a
    # module-level jax or torch import — checked on the AST of the
    # INSTALLED package, so it trips even where torch is resident.
    own_pkg_root, own_tests = _default_roots()
    own = package if pkg_root == own_pkg_root else \
        Package(own_pkg_root, 'video_features_torch', tests_dir=own_tests)
    chain_violations = closure_forbidden_imports(
        own, ('__init__.py',), 'analyzer-purity',
        'analyzer entry (the `-m` import chain must stay torch-free)')
    # (b) DYNAMIC: a forbidden root that appeared in sys.modules during
    # this run — everything above is pure ast over source text.
    late = imported_during_run(_PRELOADED if preloaded is None
                               else preloaded)
    if chain_violations or late:
        for v in chain_violations:
            print(v.render(own_pkg_root), file=sys.stderr)
        print(f'vft-lint: FATAL: the analyzer process imported '
              f'{", ".join(late) or "jax or torch (import chain)"}',
              file=sys.stderr)
        return EXIT_IMPURE
    return EXIT_FINDINGS if fresh else EXIT_CLEAN


if __name__ == '__main__':
    sys.exit(main())
