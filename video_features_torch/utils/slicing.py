"""Temporal stack slicing (port of ``video_features_tpu/utils/slicing.py``,
the reference's ``utils/utils.py:65-74``)."""
from __future__ import annotations

from typing import List, Tuple

import numpy as np


def form_slices(size: int, stack_size: int,
                step_size: int) -> List[Tuple[int, int]]:
    """Sliding-window ``(start, end)`` index pairs over ``size`` frames;
    full stacks only (floor): a partial final stack is dropped, as the
    reference does for i3d, r21d and s3d."""
    full_stack_num = (size - stack_size) // step_size + 1
    return [(i * step_size, i * step_size + stack_size)
            for i in range(max(full_stack_num, 0))]


def stack_indices(size: int, stack_size: int, step_size: int) -> np.ndarray:
    """Every window of :func:`form_slices` as one int32 gather-index array
    of shape ``(num_stacks, stack_size)``: ``frames[idx]`` gives the whole
    ``(num_stacks, stack_size, ...)`` batch in one gather."""
    slices = form_slices(size, stack_size, step_size)
    if not slices:
        return np.zeros((0, stack_size), dtype=np.int32)
    starts = np.array([s for s, _ in slices], dtype=np.int32)
    return starts[:, None] + np.arange(stack_size, dtype=np.int32)[None, :]
