"""The 3xTF32 GEMM and the fp32 depthwise convolution of the clip and
timm families' three-pass lane on the CPU (video_features_torch/ops/
gemm_tf32x3.py, ops/dwconv.py, the routes of ops/nn.py): the GEMM's
arithmetic written out in float64 per 32-K chunk, the layout its
consumers write, the tile plan, the plain versions, the refusals, and
``nn.linear`` / ``nn.matmul`` / ``nn.conv`` on and off the route."""
import numpy as np
import pytest
import torch

from video_features_torch.ops import conv_tf32x3, dwconv, nn
from video_features_torch.ops import gemm_tf32x3 as g
from video_features_torch.ops.gru import tf32_split

EMULATED_REL_L2 = 1e-6  # 3xTF32 against fp32: the dropped lo·lo, ~2^-22


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30))


def emulated(a, b, b_kn, alpha, bias):
    """The kernel's arithmetic in float64: each operand split into TF32 hi
    and lo (``tf32_split``), each 32-K chunk's lo·hi + hi·lo + hi·hi
    summed on its own, the chunks' sums added in order, then alpha, then
    the bias."""
    bt = b if b_kn else b.transpose(-1, -2)                  # (..., K, N)
    (ah, al), (bh, bl) = tf32_split(a), tf32_split(bt.contiguous())
    k = a.shape[-1]
    acc = 0
    for k0 in range(0, k, g.K_CHUNK):
        c = slice(k0, k0 + g.K_CHUNK)
        acc = acc + (al[..., c].double() @ bh[..., c, :].double()
                     + ah[..., c].double() @ bl[..., c, :].double()
                     + ah[..., c].double() @ bh[..., c, :].double())
    out = alpha * acc
    return out if bias is None else out + bias.double()


def _t(rng, *shape):
    return torch.from_numpy(rng.randn(*shape).astype(np.float32))


# (A shape, B shape, B is (K, N), alpha, bias): both layouts, a batch of
# one and two axes, a shared B, ragged M, N and K (K of 197 and 50: PV over
# ViT-B/16's and CLIP's tokens), alpha (QKᵀ's scale) and a bias
CASES = {
    'linear': ((70, 96), (40, 96), False, 1.0, True),
    'linear_ragged_k': ((33, 50), (17, 50), False, 1.0, True),
    'qk_batched': ((2, 3, 49, 32), (2, 3, 49, 32), False, 0.125, False),
    'pv_ragged_k': ((2, 3, 65, 197), (2, 3, 197, 64), True, 1.0, False),
    'pv_clip_tokens': ((6, 50, 50), (6, 50, 64), True, 1.0, False),
    'kn_shared': ((5, 64), (64, 24), True, 1.0, False),
    'kn_ragged': ((3, 37, 13), (3, 13, 9), True, 0.5, True),
    'nk_ragged': ((3, 37, 13), (3, 29, 13), False, 2.0, True),
    'one_row': ((1, 1, 128), (1, 128, 7), True, 1.0, True),
}


@pytest.mark.parametrize('name', sorted(CASES))
def test_the_kernels_arithmetic_holds_fp32(name):
    """lo·hi + hi·lo + hi·hi per 32-K chunk in float64 against the plain
    version (fp32 ``torch.matmul``) at rel L2 <= 1e-6, and the wrapper
    takes the plain version on a CPU tensor, counting no launch."""
    a_shape, b_shape, kn, alpha, with_bias = CASES[name]
    rng = np.random.RandomState(sorted(CASES).index(name))
    a, b = _t(rng, *a_shape), _t(rng, *b_shape)
    n = b_shape[-1] if kn else b_shape[-2]
    bias = _t(rng, n) if with_bias else None
    plain = g.gemm_tf32x3_plain(a, b, kn, alpha, bias)
    assert rel_l2(emulated(a, b, kn, alpha, bias), plain) <= EMULATED_REL_L2
    launches = g.gemm_tf32x3.launches
    assert torch.equal(g.gemm_tf32x3(a, b, kn, alpha, bias), plain)
    assert g.gemm_tf32x3.launches == launches
    exact = g.gemm_tf32x3_plain(a.double(), b.double(), kn, alpha,
                                None if bias is None else bias.double())
    assert rel_l2(plain, exact) <= EMULATED_REL_L2


def test_the_split_tile_layout_is_the_conv_packs():
    """Where the consumers store natural K position kk of row n
    (``split_positions``, ``csrc/gemm_tf32x3.cu::split_pos``) is where
    ``conv_tf32x3.pack_weight`` puts it: the fragment order
    (``K_ORDER``) under the 128-byte swizzle that the descriptors read."""
    for bn in g.GEMM_WIDTHS:
        natural = conv_tf32x3._pack_index_of(bn, torch.device('cpu'))
        pos = g.split_positions(bn)
        rows = torch.arange(bn)[:, None].expand(bn, g.K_CHUNK)
        assert torch.equal(natural[rows, pos],
                           torch.arange(g.K_CHUNK).expand(bn, g.K_CHUNK))
        assert torch.equal(pos.sort(dim=1).values,
                           torch.arange(g.K_CHUNK).expand(bn, g.K_CHUNK))


@pytest.mark.parametrize('b_kn', [False, True])
def test_a_weight_pack_is_the_conv_pack_at_the_gemms_width(b_kn):
    """A shared B's pack (``weight_pack``) is ``conv_tf32x3.pack_weight``
    of its (N, K) form at the call's tile width: tile t, chunk q holds
    rows t·bn … of N, each row's K value q·32 + kk at ``split_positions``,
    hi then lo; padded rows and K are zeros. A (K, N) weight (CLIP's
    projections) is packed transposed."""
    rng = np.random.RandomState(9)
    n, k = 70, 100
    w = _t(rng, k, n) if b_kn else _t(rng, n, k)
    nk = w.t() if b_kn else w
    bn = g.gemm_plan(1, 500, n).bn
    pack = g.weight_pack(w, b_kn, bn)
    assert tuple(pack.shape) == (-(-n // bn), -(-k // 32), 2, bn, 32)
    assert torch.equal(pack, conv_tf32x3.pack_weight(nk.contiguous(), bn=bn))
    hi, lo = tf32_split(nk)
    pos = g.split_positions(bn)
    for t in range(pack.shape[0]):
        for q in range(pack.shape[1]):
            for r in range(bn):
                row, cols = t * bn + r, slice(q * 32, q * 32 + 32)
                got_hi = pack[t, q, 0, r][pos[r]]
                got_lo = pack[t, q, 1, r][pos[r]]
                if row >= n:
                    assert not got_hi.any() and not got_lo.any()
                    continue
                want_hi = torch.zeros(32)
                want_lo = torch.zeros(32)
                width = min(32, k - q * 32)
                want_hi[:width] = hi[row, cols]
                want_lo[:width] = lo[row, cols]
                assert torch.equal(got_hi, want_hi)
                assert torch.equal(got_lo, want_lo)


def test_the_pack_cache_holds_a_pack_for_its_weights_life():
    """One pack per weight: a hit on the second call, a fresh pack after
    an in-place update (its version moves), one per tile width, freed
    with its weight; an inference tensor (no version counter) is packed at
    every call and never held."""
    import gc
    import weakref
    from video_features_torch.ops import weight_packs
    rng = np.random.RandomState(10)
    w = _t(rng, 48, 64)
    packs, live = g.gemm_tf32x3.packs, weight_packs.live()
    first = g.weight_pack(w, False, 64)
    assert g.weight_pack(w, False, 64) is first
    assert g.gemm_tf32x3.packs == packs + 1
    assert weight_packs.live() == live + 1
    assert weight_packs.device_bytes('cpu') >= first.numel() * 4
    w.add_(1.0)
    second = g.weight_pack(w, False, 64)
    assert second is not first and g.gemm_tf32x3.packs == packs + 2
    assert torch.equal(second, conv_tf32x3.pack_weight(w, bn=64))
    assert g.weight_pack(w, False, 32) is not second      # another width
    assert weight_packs.live() == live + 2
    ref = weakref.ref(second)
    del w, first, second
    gc.collect()
    assert ref() is None and weight_packs.live() == live
    with torch.inference_mode():
        frozen = _t(rng, 16, 32)
    assert frozen.is_inference()
    before = g.gemm_tf32x3.packs
    a, b = g.weight_pack(frozen, False, 16), g.weight_pack(frozen, False, 16)
    assert a is not b and torch.equal(a, b)
    assert g.gemm_tf32x3.packs == before + 2
    assert weight_packs.live() == live


@pytest.mark.parametrize('batch,m,n,want', [
    (1, 6304, 2304, (128, 128, 18)),     # ViT-B/16 qkv at batch 32
    (1, 6304, 768, (128, 128, 6)),
    (384, 197, 197, (128, 128, 2)),      # its QKᵀ: 2 × 128 columns
    (384, 197, 64, (128, 64, 1)),        # its PV
    (384, 50, 50, (64, 64, 1)),          # CLIP ViT-B/32's 50 tokens
    (1536, 49, 49, (64, 64, 1)),         # swin_tiny's windows at batch 8
    (1536, 49, 32, (64, 32, 1)),
    (1, 8, 1000, (64, 16, 63)),          # a classifier head: narrow tiles
    (1, 1000, 10, (64, 16, 1)),          # few blocks: 64-row tiles
    (1, 32, 512, (64, 16, 32)),          # CLIP's projection at batch 32
    (8, 50, 2048, (64, 64, 32)),         # RN50's attention pool at batch 8
])
def test_the_tile_plan(batch, m, n, want):
    plan = g.gemm_plan(batch, m, n)
    assert tuple(plan) == want
    assert plan.bn in g.GEMM_WIDTHS and plan.tiles * plan.bn >= n
    occ = g.occupancy(m, n, plan)
    assert 0 < occ <= 1
    if (batch, m, n) == (384, 50, 50):
        assert occ == pytest.approx(50 * 50 / (64 * 64))


@pytest.mark.parametrize('case,match', [
    ('k', 'agree on K'), ('dtype', 'float32'), ('last_axis', 'last axis'),
    ('batch', 'batch axes'), ('three_axes', 'at most two batch axes'),
    ('bias', 'bias must be'), ('device', 'float32 tensor on')])
def test_the_gemm_refuses_what_the_kernel_does_not_take(case, match):
    """The wrapper's checks raise on the CPU as on the card: no fallback."""
    rng = np.random.RandomState(3)
    a, b, bias = _t(rng, 2, 8, 16), _t(rng, 2, 12, 16), None
    if case == 'k':
        b = _t(rng, 2, 12, 15)
    elif case == 'dtype':
        a = a.double()
    elif case == 'last_axis':
        a = _t(rng, 2, 16, 8).transpose(-1, -2)
    elif case == 'batch':
        b = _t(rng, 3, 12, 16)
    elif case == 'three_axes':
        a, b = _t(rng, 2, 2, 2, 8, 16), _t(rng, 2, 2, 2, 12, 16)
    elif case == 'bias':
        bias = _t(rng, 13)
    elif case == 'device':
        bias = _t(rng, 12).to('meta')
    with pytest.raises(ValueError, match=match):
        g.gemm_tf32x3(a, b, False, 1.0, bias)


# -- the depthwise convolution -----------------------------------------------------

DW_CASES = {
    'convnext_7x7': ((2, 14, 14, 24), 7, 1, 3),
    'effnet_3x3_s2': ((2, 15, 13, 16), 3, 2, 1),
    'effnet_5x5_s2': ((1, 16, 16, 12), 5, 2, 2),
    'odd_channels_asymmetric': ((2, 9, 7, 6), 3, 2, [(1, 0), (0, 2)]),
}


@pytest.mark.parametrize('name', sorted(DW_CASES))
def test_the_depthwise_plain_version_is_the_grouped_library_conv(name):
    """The plain version is ``library_conv(groups=C)`` in fp32 (and within
    1e-6 of float64: exact products, fp32 sums over the taps), and a CPU
    tensor takes it through the wrapper and the route, with no launch."""
    xs, k, stride, padding = DW_CASES[name]
    rng = np.random.RandomState(4)
    x, w, b = _t(rng, *xs), _t(rng, xs[-1], 1, k, k), _t(rng, xs[-1])
    want = nn.library_conv(x, w, stride, padding, b, xs[-1])
    launches = dwconv.dwconv_f32.launches
    assert torch.equal(dwconv.dwconv_f32_plain(x, w, stride, padding, b), want)
    assert torch.equal(dwconv.dwconv_f32(x, w, stride, padding, b), want)
    with nn.conv_route('kernel'):
        assert torch.equal(nn.conv(x, w, stride, padding, b, xs[-1]), want)
    assert dwconv.dwconv_f32.launches == launches
    exact = nn.library_conv(x.double(), w.double(), stride, padding,
                            b.double(), xs[-1])
    assert rel_l2(want, exact) <= EMULATED_REL_L2


# the timm CNNs' depthwise outputs at batch 8, (n, oh, ow, c), kernel and
# strides, and the plan: (channel groups, rows) per block
DW_PLANS = {
    'convnext 56': ((8, 56, 56, 96), (7, 7, 1, 1), (8, 4)),
    'convnext 28': ((8, 28, 28, 192), (7, 7, 1, 1), (8, 4)),
    'convnext 14': ((8, 14, 14, 384), (7, 7, 1, 1), (2, 14)),
    'convnext 7': ((8, 7, 7, 768), (7, 7, 1, 1), (4, 7)),
    'effnet 112': ((8, 112, 112, 32), (3, 3, 1, 1), (8, 2)),
    'effnet 56 s2': ((8, 56, 56, 96), (3, 3, 2, 2), (8, 2)),   # the patch's budget
    'effnet 7 s1': ((8, 7, 7, 1152), (3, 3, 1, 1), (8, 7)),
    'batch 64 at 7': ((64, 7, 7, 768), (7, 7, 1, 1), (32, 7)),
    'odd channels': ((2, 7, 6, 6), (3, 3, 2, 2), (1, 7)),
}


@pytest.mark.parametrize('name', sorted(DW_PLANS))
def test_the_depthwise_tile_plan(name):
    """Small maps take the whole map a block and halve their channel
    groups, wide ones up to 8 groups and halve their rows, until the
    blocks are at least twice the SMs; the staged patch fits the budget;
    every block fits the kernel's 256 threads and covers its rows' every
    column; its shared memory is the kernel's patch and taps."""
    (n, oh, ow, c), (kh, kw, sh, sw), want = DW_PLANS[name]
    plan = dwconv.dw_plan(n, oh, ow, c, kh, kw, sh, sw)
    assert (plan.cg, plan.rows) == want
    assert plan.cg * plan.rows * plan.strips <= dwconv.THREADS
    assert plan.strips * dwconv.STRIP >= ow > (plan.strips - 1) * dwconv.STRIP
    assert plan.blocks == n * -(-oh // plan.rows) * -(-(-(-c // 4)) // plan.cg)
    assert plan.blocks >= 2 * dwconv.SMS or plan.rows == 1 or plan.cg == 1
    if oh <= 14:
        assert plan.rows == oh
    pr, pc = (plan.rows - 1) * sh + kh, (plan.strips * 7 - 1) * sw + kw
    assert plan.smem == (pr * pc + kh * kw) * plan.cg * 16 <= dwconv.SMEM_BUDGET


@pytest.mark.parametrize('c', [6, 16])
def test_the_depthwise_taps_are_packed_tap_major(c):
    """``pack_taps``: tap t of channel ch at (t, ch), channels padded to a
    multiple of 4 with zeros, so one 16-byte load is a tap of 4
    channels."""
    rng = np.random.RandomState(11)
    w = _t(rng, c, 1, 3, 5)
    taps = dwconv.pack_taps(w)
    assert tuple(taps.shape) == (15, -(-c // 4) * 4) and taps.is_contiguous()
    for ch in range(c):
        for dh in range(3):
            for dw in range(5):
                assert taps[dh * 5 + dw, ch] == w[ch, 0, dh, dw]
    assert not taps[:, c:].any()


@pytest.mark.parametrize('k,stride', [(3, 1), (3, 2), (5, 1), (5, 2), (7, 1)])
def test_the_staged_yardstick_fits_the_paths_kernels(k, stride):
    """The staged yardstick's patch and taps (``smem_bytes``) fit a block
    at every kernel size and stride of the timm CNNs' path."""
    assert dwconv.smem_bytes(k, k, stride, stride) <= dwconv.SMEM_OPTIN


@pytest.mark.parametrize('case,match', [
    ('not_depthwise', 'depthwise'), ('dtype', 'float32'),
    ('contiguous', 'contiguous'), ('bias', 'bias must be'),
    ('empty', 'empty output'), ('wide', 'at most 7 taps'),
    ('stride', 'stride of 1 or 2')])
def test_the_depthwise_kernel_refuses_what_it_does_not_take(case, match):
    rng = np.random.RandomState(5)
    x, w, b, stride = _t(rng, 1, 8, 8, 12), _t(rng, 12, 1, 3, 3), None, 1
    if case == 'not_depthwise':
        w = _t(rng, 12, 2, 3, 3)
    elif case == 'dtype':
        x = x.double()
    elif case == 'contiguous':
        x = _t(rng, 1, 12, 8, 8).permute(0, 2, 3, 1)
    elif case == 'bias':
        b = _t(rng, 6)
    elif case == 'empty':
        w = _t(rng, 12, 1, 9, 9)
    elif case == 'wide':
        w = _t(rng, 12, 1, 1, 8)
    elif case == 'stride':
        w, stride = _t(rng, 12, 1, 3, 3), (1, 3)
    with pytest.raises(ValueError, match=match):
        dwconv.dwconv_f32(x, w, stride, 0, b)


# -- the routes of ops/nn.py -------------------------------------------------------


def test_linear_and_matmul_off_the_route_are_torch_calls():
    """Outside a products route (and inside a route without ``products``,
    the six convolutional families' lane) ``linear`` is ``F.linear`` and
    ``matmul`` is ``@`` (times alpha), bytes and all."""
    rng = np.random.RandomState(6)
    x, w, b = _t(rng, 2, 5, 16), _t(rng, 8, 16), _t(rng, 8)
    q, k = _t(rng, 2, 3, 5, 4), _t(rng, 2, 3, 5, 4)
    for scope in (nn.conv_route(None), nn.conv_route('kernel')):
        with scope:
            assert torch.equal(nn.linear(x, {'weight': w, 'bias': b}),
                               torch.nn.functional.linear(x, w, b))
            assert torch.equal(nn.matmul(q, k.transpose(-1, -2), alpha=0.5),
                               (q @ k.transpose(-1, -2)) * 0.5)


@pytest.mark.parametrize('route', nn.CONV_ROUTES)
def test_the_products_route_sends_linear_and_matmul_to_the_gemm(
        monkeypatch, route):
    """Inside ``conv_route(route, products=True)``: ``linear`` is one GEMM
    on the flattened rows and the (O, I) weight with the bias; ``matmul``
    one GEMM with alpha, a transposed view of an (N, K) tensor read as
    (N, K) and a (K, N) one as (K, N), neither copied; an operand that
    is not contiguous along its last axis is copied once and counted."""
    calls = []

    def spy(fn):
        def call(a, b, b_kn, alpha, bias):
            calls.append((tuple(a.shape), tuple(b.shape), b_kn, alpha,
                          bias is not None, a.is_contiguous()))
            return fn(a, b, b_kn, alpha, bias)
        return call
    name = 'gemm_tf32x3' if route == 'kernel' else 'gemm_tf32x3_plain'
    monkeypatch.setattr(g, name, spy(getattr(g, name)))
    rng = np.random.RandomState(7)
    x, w, b = _t(rng, 2, 5, 16), _t(rng, 8, 16), _t(rng, 8)
    qkv = _t(rng, 2, 5, 3, 3, 4)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))
    copies = nn.matmul.copies
    with nn.conv_route(route, products=True):
        y = nn.linear(x, {'weight': w, 'bias': b})
        s = nn.matmul(q, k.transpose(-1, -2), alpha=0.5)
        o = nn.matmul(torch.softmax(s, -1), v)
        t = nn.linear(x.transpose(1, 2), {'weight': _t(rng, 4, 5)})
    assert calls == [((10, 16), (8, 16), False, 1.0, True, True),
                     ((2, 3, 5, 4), (2, 3, 5, 4), False, 0.5, False, False),
                     ((2, 3, 5, 5), (2, 3, 5, 4), True, 1.0, False, True),
                     ((32, 5), (4, 5), False, 1.0, False, True)]
    assert nn.matmul.copies == copies + 1       # the transposed activation
    assert y.shape == (2, 5, 8) and t.shape == (2, 16, 4)
    assert rel_l2(y, torch.nn.functional.linear(x, w, b)) <= 1e-6
    assert rel_l2(s, (q @ k.transpose(-1, -2)) * 0.5) <= 1e-6
    assert rel_l2(o, torch.softmax(s, -1) @ v) <= 1e-6


def test_the_route_sends_depthwise_convs_to_dwconv_and_grouped_ones_on():
    """Inside a route a convolution with one input and one output channel
    per group goes to the depthwise kernel's wrapper, a grouped one with
    more (RegNet's group widths, ResNeXt's) to the 3xTF32 convolution's."""
    rng = np.random.RandomState(8)
    x = _t(rng, 1, 6, 6, 16)
    dw, grouped = _t(rng, 16, 1, 3, 3), _t(rng, 16, 8, 3, 3)
    assert dwconv.is_depthwise(x, dw, 16)
    assert not dwconv.is_depthwise(x, grouped, 2)
    assert not dwconv.is_depthwise(x, _t(rng, 16, 16, 1, 1), 1)
    seen = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(dwconv, 'dwconv_f32',
                   lambda *a: seen.append('dw') or dwconv.dwconv_f32_plain(*a))
        mp.setattr(conv_tf32x3, 'conv_tf32x3',
                   lambda *a: seen.append('conv') or
                   conv_tf32x3.conv_tf32x3_plain(*a))
        with nn.conv_route('kernel'):
            nn.conv(x, dw, 1, 1, None, 16)
            nn.conv(x, grouped, 1, 1, None, 2)
    assert seen == ['dw', 'conv']
