"""Top-k prediction printing for ``show_pred`` (a copy of
``video_features_tpu/utils/preds.py``: Kinetics-400, ImageNet-1k and
ImageNet-21k).

The label maps ship as package data in ``utils/label_maps/``, so class
names resolve on hosts with no network; ``$VFT_LABEL_MAP_DIR`` takes
precedence for user-refreshed maps, and when nothing resolves, indices
are printed instead of failing.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import List, Optional, Union

import numpy as np

_DATASET_TO_FILE = {
    'kinetics': 'K400_label_map.txt',
    'imagenet1k': 'IN1K_label_map.txt',
    'imagenet21k': 'IN21K_label_map.txt',
}


def _search_dirs() -> List[str]:
    # the env var is read per call, so setting it after import takes effect
    return [os.environ.get('VFT_LABEL_MAP_DIR', ''),
            str(Path(__file__).parent / 'label_maps')]


def load_label_map(dataset: str) -> Optional[List[str]]:
    fname = _DATASET_TO_FILE.get(dataset)
    if fname is None:
        return None
    for d in _search_dirs():
        if d and (Path(d) / fname).exists():
            with open(Path(d) / fname) as f:
                return [line.strip() for line in f]
    return None


def softmax(x: np.ndarray, axis: int = -1) -> np.ndarray:
    x = x - x.max(axis=axis, keepdims=True)
    e = np.exp(x)
    return e / e.sum(axis=axis, keepdims=True)


def show_predictions_on_dataset(logits: np.ndarray,
                                dataset: Union[str, List[str]], k: int = 5) -> None:
    """Print a top-k table of logits/probabilities/labels per batch row."""
    logits = np.asarray(logits)
    classes = load_label_map(dataset) if isinstance(dataset, str) else list(dataset)
    probs = softmax(logits)
    top_idx = np.argsort(-probs, axis=-1)[:, :k]
    for b in range(logits.shape[0]):
        # vft-lint: ok=stdout-purity — show_pred's top-k table IS the
        # deliberate stdout surface of this debug mode (reference parity)
        print('  Logits | Prob. | Label ')
        for idx in top_idx[b]:
            label = classes[idx] if classes and idx < len(classes) else f'class_{idx}'
            # vft-lint: ok=stdout-purity — show_pred table row
            print(f'{logits[b, idx]:8.3f} | {probs[b, idx]:.3f} | {label}')
        # vft-lint: ok=stdout-purity — show_pred table spacer
        print()
