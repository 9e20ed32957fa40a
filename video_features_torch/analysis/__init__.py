"""vft-lint, vft-wire and vft-programs for the port (port of
``video_features_tpu/analysis``).

``python -m video_features_torch.analysis`` parses the whole package
with :mod:`ast` — never importing it, nor jax, nor torch — and enforces
the contracts the repo states in prose: spawn-worker purity (no jax, no
torch in a decode worker), the knob-classification registry, no
silently swallowed exceptions, stdout purity, export-schema /
stage-vocabulary sync, recipe picklability, thread-discipline
declarations, lock order and wire literals.
``python -m video_features_torch.analysis.wire`` checks the serve and
ingress wire against the repo-root ``WIRE.lock.json``, which the port
shares with the JAX package and never writes;
``python -m video_features_torch.analysis.programs`` pins each family's
step, exported with ``torch.export`` on fake CUDA tensors, in
``analysis/PROGRAMS.lock.json``. The README's port section has the rule
catalog, the suppression syntax and the recorded divergences.
"""
from video_features_torch.analysis.checks import (
    ALL_CHECKS, RULES, analyze, run_checks,
)
from video_features_torch.analysis.core import (
    Finding, Module, Package, filter_suppressed, load_baseline,
    new_findings, write_baseline,
)

__all__ = [
    'ALL_CHECKS', 'RULES', 'analyze', 'run_checks', 'Finding', 'Module',
    'Package', 'filter_suppressed', 'load_baseline', 'new_findings',
    'write_baseline',
]
