"""``video_features_torch/utils/slicing.py`` against the JAX package's
``utils/slicing.py``: the same windows and the same gather indices."""
import numpy as np
import pytest

from video_features_tpu.utils import slicing as jax_slicing
from video_features_torch.utils import slicing

CASES = [(0, 16, 16), (15, 16, 16), (16, 16, 16), (17, 16, 16), (64, 16, 8),
         (65, 17, 16), (100, 64, 64), (5, 1, 1), (10, 3, 4), (7, 8, 1)]


@pytest.mark.parametrize('size,stack,step', CASES)
def test_form_slices_matches_the_jax_helper(size, stack, step):
    assert slicing.form_slices(size, stack, step) == \
        jax_slicing.form_slices(size, stack, step)


@pytest.mark.parametrize('size,stack,step', CASES)
def test_stack_indices_match_the_jax_helper(size, stack, step):
    ours = slicing.stack_indices(size, stack, step)
    theirs = jax_slicing.stack_indices(size, stack, step)
    assert ours.dtype == theirs.dtype == np.int32
    assert ours.shape == theirs.shape
    np.testing.assert_array_equal(ours, theirs)


def test_stack_indices_gather_the_form_slices_windows():
    frames = np.arange(50)
    idx = slicing.stack_indices(50, 16, 8)
    for row, (start, end) in zip(idx, slicing.form_slices(50, 16, 8)):
        np.testing.assert_array_equal(frames[row], frames[start:end])
