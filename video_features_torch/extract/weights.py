"""Checkpoint resolution with a loud failure when weights are missing
(port of ``video_features_tpu/extract/weights.py``).

A missing checkpoint path is a hard error: silently running random
weights would hand the user plausible-looking garbage features. Tests
and smoke runs that mean to run random weights set
``allow_random_weights=true`` (or ``VFT_ALLOW_RANDOM_WEIGHTS=1``).
"""
from __future__ import annotations

import os
import sys
from typing import Any, Callable, Dict, Iterable, Optional

from video_features_torch.transplant import (
    Params, load_checkpoint, params_from_torch, to_lane,
)

ENV_FLAG = 'VFT_ALLOW_RANDOM_WEIGHTS'


class MissingCheckpointError(ValueError):
    """No checkpoint configured and random weights were not explicitly allowed."""


def _get(args: Any, key: str, default: Any = None) -> Any:
    if hasattr(args, 'get'):
        return args.get(key, default)
    return getattr(args, key, default)


def random_weights_allowed(args: Any) -> bool:
    if _get(args, 'allow_random_weights'):
        return True
    return os.environ.get(ENV_FLAG, '').lower() not in ('', '0', 'false')


def require_checkpoint(args: Any, key: str, *, feature_type: str,
                       what: Optional[str] = None) -> Optional[str]:
    """``args[key]``, or None when random init is explicitly allowed;
    raises :class:`MissingCheckpointError` otherwise."""
    ckpt = _get(args, key)
    if ckpt:
        return str(ckpt)
    what = what or feature_type
    if not random_weights_allowed(args):
        raise MissingCheckpointError(
            f'No checkpoint configured for {what}: set `{key}=<path to a '
            f'.pt/.pth/.npz checkpoint>` (feature_type={feature_type}). '
            f'Provision real weights with `python tools/fetch_checkpoints.py '
            f'{feature_type}` (see docs/checkpoints.md). To intentionally '
            f'run RANDOM weights (tests/benchmarks only — features will be '
            f'meaningless), set `allow_random_weights=true`.')
    print(f'WARNING: {what}: no `{key}` configured — running RANDOM weights '
          f'(allow_random_weights is set). Extracted features are '
          f'meaningless for downstream use.', file=sys.stderr)
    return None


def load_or_init(args: Any, key: str,
                 init_fn: Callable[[], Dict[str, Any]], *,
                 feature_type: str, what: Optional[str] = None,
                 compute_dtype: str = 'float32') -> Params:
    """Params from ``args[key]``, or the gated random init, cast for
    the ``compute_dtype`` lane (:func:`lane_params`)."""
    ckpt = require_checkpoint(args, key, feature_type=feature_type, what=what)
    params = load_checkpoint(ckpt) if ckpt else params_from_torch(init_fn())
    return lane_params(params, compute_dtype, ckpt)


def lane_params(params: Params, compute_dtype: str,
                checkpoint: Optional[str] = None,
                no_transpose: Iterable[str] = ()) -> Params:
    """``params`` cast once for the ``compute_dtype`` lane
    (``transplant.to_lane``); on the int8 lane a checkpoint's pinned
    scale table ``<checkpoint>.int8-scales.npz`` is consumed verbatim."""
    scales = None
    if compute_dtype == 'int8' and checkpoint:
        from video_features_torch.ops.quant import (
            load_scale_table, scale_table_path,
        )
        scales = load_scale_table(scale_table_path(checkpoint))
    return to_lane(params, compute_dtype, no_transpose, scales)
