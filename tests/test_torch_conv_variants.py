"""The 3xTF32 convolution's ablation tool (tools/conv_tf32x3_variants.py)
patches ``csrc/conv_tf32x3.cu`` textually. Every anchor must occur exactly
once in the source, so that a refactor of the kernel fails here, on the
CPU, instead of after a build on the card. The tool imports torch only
inside ``main()``: nothing is built."""
import pytest

from tools import conv_tf32x3_variants as variants
from video_features_torch.ops import conv_tf32x3 as k

SOURCE = variants.SRC.read_text()


@pytest.mark.parametrize('name', sorted(variants.PATCHES))
def test_every_anchor_occurs_once(name):
    for anchor, replacement in variants.PATCHES[name]:
        assert SOURCE.count(anchor) == 1, (name, anchor)
        assert anchor != replacement
    patched = variants.patched_source(name)
    assert (patched == SOURCE) == (not variants.PATCHES[name])


def test_feed_bytes_reckoning():
    # convc2 at the fused batch-8 size: 1,376 blocks of 128 pixels per
    # output tile, two tiles of 96, 72 chunks: 24 KB of hi | lo weights and
    # 16 KB of rows per block and chunk
    fb = variants.feed_bytes(176128, (192, 256, 3, 3), 128)
    assert fb['weights'] == 1376 * 2 * 72 * 2 * 96 * 128
    assert fb['rows'] == 1376 * 2 * 72 * 128 * 128
    assert fb['total'] == fb['weights'] + fb['rows']
    # the 2-channel flow stem: each tap's channels padded to 4
    assert variants.feed_bytes(802816, (64, 2, 7, 7, 7), 128)['rows'] == \
        6272 * 43 * 128 * 128


def test_the_cases_cover_the_seven_and_the_i3d_three():
    names = [c[0] for c in variants.CASES]
    assert len(names) == 17 and len(set(names)) == 17
    for name, xs, ws, stride, pad in variants.CASES:
        assert xs[-1] == ws[1] and len(xs) == len(ws)
        assert k.packed_shape(ws)[3] in k.TILE_WIDTHS
