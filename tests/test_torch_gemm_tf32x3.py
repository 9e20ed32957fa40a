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


@pytest.mark.parametrize('batch,m,n,want', [
    (1, 6304, 2304, (128, 128, 18)),     # ViT-B/16 qkv at batch 32
    (1, 6304, 768, (128, 128, 6)),
    (384, 197, 197, (128, 128, 2)),      # its QKᵀ: 2 × 128 columns
    (384, 197, 64, (128, 64, 1)),        # its PV
    (384, 50, 50, (64, 64, 1)),          # CLIP ViT-B/32's 50 tokens
    (1536, 49, 49, (64, 64, 1)),         # swin_tiny's windows at batch 8
    (1536, 49, 32, (64, 32, 1)),
    (1, 8, 1000, (64, 128, 8)),          # a classifier head
    (1, 1000, 10, (64, 16, 1)),          # few blocks: 64-row tiles
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


@pytest.mark.parametrize('case,match', [
    ('not_depthwise', 'depthwise'), ('dtype', 'float32'),
    ('contiguous', 'contiguous'), ('bias', 'bias must be'),
    ('empty', 'empty output')])
def test_the_depthwise_kernel_refuses_what_it_does_not_take(case, match):
    rng = np.random.RandomState(5)
    x, w, b = _t(rng, 1, 8, 8, 12), _t(rng, 12, 1, 3, 3), None
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
    with pytest.raises(ValueError, match=match):
        dwconv.dwconv_f32(x, w, 1, 0, b)


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
