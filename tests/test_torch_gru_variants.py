"""The GRU kernel's ablation tool (tools/gru_tf32x3_variants.py) patches
``csrc/gru_direction.cu`` textually. Every anchor must occur exactly once
in the source, so that a refactor of the kernel fails here, on the CPU,
instead of after a build on the card. The tool imports torch only inside
``main()``: nothing is built."""
import pytest

from tools import gru_tf32x3_variants as variants

SOURCE = variants.SRC.read_text()


@pytest.mark.parametrize('name', sorted(variants.PATCHES))
def test_every_anchor_occurs_once(name):
    for anchor, replacement in variants.PATCHES[name]:
        assert SOURCE.count(anchor) == 1, (name, anchor)
        assert anchor != replacement
    patched = variants.patched_source(name)
    assert (patched == SOURCE) == (not variants.PATCHES[name])


def test_feed_bytes_reckoning():
    # the fused I3D path's batch-8 grid, 128-pixel tiles, one CTA per
    # cluster: 4128 blocks per direction, 640 KiB of hi tiles each
    fb = variants.feed_bytes((128, 32, 43), 'w', 1, 128)
    assert fb['weights'] == 4128 * 40 * 16384
    assert fb['activations'] == 4128 * 8 * 132 * 128
    # a cluster of 2 halves the weights; 3xTF32 doubles them (hi and lo)
    assert variants.feed_bytes((128, 32, 43), 'w', 2, 128)['weights'] == \
        fb['weights'] / 2
    assert variants.feed_bytes((128, 32, 43), 'w', 1, 128, passes=3)[
        'weights'] == 2 * fb['weights']
    # axis 'h' stages +-2 rows of W = 43 pixels
    assert variants.feed_bytes((128, 32, 43), 'h', 1, 128)['activations'] == \
        4128 * 8 * 300 * 128
    # 3 tiles in clusters of 2: 4 CTAs per GEMM column
    assert variants.feed_bytes((1, 5, 60), 'w', 2, 128)['weights'] == \
        3 * 4 * 40 * 16384 / 2
