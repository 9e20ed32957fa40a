"""The port's int8 weight lane (video_features_torch/ops/quant.py, the
``compute_dtype=int8`` seam of transplant.py and extract/weights.py)
against the JAX package's (video_features_tpu/ops/quant.py), on the CPU:
the same int8 bytes and scales for seeded resnet18, a narrow CLIP and a
narrow ViT, the same quantized names, a scale table written by the JAX
package consumed verbatim, and features that match the JAX package's
int8 lane."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from video_features_tpu.extract.clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.extract.resnet import ExtractResNet as JaxExtractResNet
from video_features_tpu.extract.timm import ExtractTIMM as JaxExtractTIMM
from video_features_tpu.models import clip as jax_clip
from video_features_tpu.models import resnet as jax_resnet
from video_features_tpu.models import vit as jax_vit
from video_features_tpu.ops import quant as jax_quant
from video_features_tpu.ops.precision import INT8_REL_L2_BOUNDS
from video_features_tpu.transplant.torch2jax import transplant
from video_features_torch.config import load_config
from video_features_torch.extract import clip as clip_ex
from video_features_torch.extract import resnet as resnet_ex
from video_features_torch.extract import timm as timm_ex
from video_features_torch.extract.weights import lane_params
from video_features_torch.models import vit
from video_features_torch.ops import quant
from video_features_torch.ops.precision import rel_l2
from video_features_torch.registry import create_extractor
from video_features_torch.transplant import flatten, params_from_torch

# both packages dequantize the same int8 bytes, then compute in float32
# with their own sum orders
REL_L2 = 1e-5
VIT_TEST = dict(width=64, layers=2, heads=2, patch=16)


@pytest.fixture(autouse=True)
def one_thread():
    """oneDNN's multi-threaded fp32 convolution can put ~4e-5 of error in
    one thread's chunk; one thread holds 1e-5."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope='module')
def nets():
    """{name: (state_dict, no_transpose, port step, JAX step, input)} for
    seeded resnet18, CLIP ViT-B/32 cut to two blocks and a narrow ViT
    added to both packages' ARCHS."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(vit.ARCHS, 'vit_test', VIT_TEST)
        mp.setitem(jax_vit.ARCHS, 'vit_test', VIT_TEST)
        clip_sd = {k: v for k, v in jax_clip.init_state_dict(seed=0).items()
                   if not (k.startswith('visual.transformer.resblocks.')
                           and int(k.split('.')[3]) >= 2)}
        mean, std = timm_ex.vit_model.MEAN, timm_ex.vit_model.STD
        rng = np.random.RandomState(3)
        yield {
            'resnet': (jax_resnet.init_state_dict(seed=1, arch='resnet18'), (),
                       lambda p, x: resnet_ex.resnet_step(p, x, 'resnet18'),
                       lambda p, x: JaxExtractResNet._forward(p, x, arch='resnet18'),
                       rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)),
            'clip': (clip_sd, tuple(jax_clip.NO_TRANSPOSE),
                     lambda p, x: clip_ex.clip_step(p, x, 'ViT-B/32'),
                     lambda p, x: JaxExtractCLIP._forward(p, x, arch='ViT-B/32'),
                     rng.randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)),
            'timm': (jax_vit.init_state_dict(arch='vit_test'), (),
                     lambda p, x: timm_ex.timm_step(p, x, 'vit', 'vit_test',
                                                    mean, std),
                     lambda p, x: JaxExtractTIMM._forward(
                         p, x, family='vit', arch='vit_test', mean=mean, std=std),
                     rng.randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)),
        }


def _jax_flat(tree, prefix=''):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_jax_flat(v, f'{prefix}{k}.'))
        else:
            out[f'{prefix}{k}'] = v
    return out


def _torch_layout(name: str, arr: np.ndarray, no_transpose) -> np.ndarray:
    """A JAX-layout leaf in torch's layout (the transplant's re-layout
    undone): '.weight' (*spatial, I, O) → (O, I, *spatial), (I, O) → (O, I)."""
    if name.split('.')[-1] != 'weight' or name in no_transpose or arr.ndim < 2:
        return arr
    if arr.ndim == 2:
        return arr.T
    return arr.transpose((arr.ndim - 1, arr.ndim - 2) + tuple(range(arr.ndim - 2)))


def _lanes(sd, no_transpose, scales=None):
    """(JAX int8 flat params, port int8 flat params) of one state_dict."""
    theirs = _jax_flat(transplant(sd, no_transpose=set(no_transpose),
                                  dtype=np.int8, scales=scales))
    ours = flatten(lane_params(params_from_torch(sd), 'int8',
                               no_transpose=no_transpose))
    return theirs, ours


@pytest.mark.parametrize('name', ['resnet', 'clip', 'timm'])
def test_quantized_bytes_equal_the_jax_packages(nets, name):
    """q and scale byte for byte, after the channel axis moves first; the
    same names quantized; every other leaf float32."""
    sd, no_transpose = nets[name][:2]
    theirs, ours = _lanes(sd, no_transpose)
    assert theirs.keys() == ours.keys()
    quantized = {k for k, v in theirs.items()
                 if isinstance(v, jax_quant.QuantizedTensor)}
    assert quantized == {k for k, v in ours.items()
                         if isinstance(v, quant.QuantizedTensor)}
    assert len(quantized) >= 10
    for k in quantized:
        q = _torch_layout(k, np.asarray(theirs[k].q), no_transpose)
        assert ours[k].q.dtype == torch.int8
        assert np.array_equal(ours[k].q.numpy(), q), k
        assert ours[k].scale.dtype == torch.float32
        assert ours[k].scale.shape[0] == ours[k].q.shape[0]
        assert np.array_equal(ours[k].scale.numpy().ravel(),
                              np.asarray(theirs[k].scale).ravel()), k
    for k in set(ours) - quantized:
        if ours[k].is_floating_point():
            assert ours[k].dtype == torch.float32, k


def test_embeddings_and_small_leaves_stay_float32(nets):
    sd, no_transpose = nets['clip'][:2]
    _, ours = _lanes(sd, no_transpose)
    for k in ('token_embedding.weight', 'positional_embedding',
              'visual.class_embedding', 'visual.ln_pre.weight', 'visual.proj'):
        assert isinstance(ours[k], torch.Tensor) and ours[k].dtype == torch.float32
    assert isinstance(ours['visual.transformer.resblocks.0.attn.in_proj_weight'],
                      quant.QuantizedTensor)


def test_quantize_arithmetic():
    """scale = amax/127 per output channel, an all-zero channel 1.0;
    q = rint(w/scale) clipped to ±127; dequantize = q·scale."""
    w = torch.tensor([[0.0, 0.0, 0.0], [1.27, -0.635, 0.005],
                      [-2.54, 1.0, 0.0]])
    t = quant.quantize_tensor(w)
    assert t.scale.ravel().tolist() == pytest.approx([1.0, 0.01, 0.02])
    assert t.q.tolist() == [[0, 0, 0], [127, -64, 0], [-127, 50, 0]]
    assert torch.equal(t.dequantize(), t.q.float() * t.scale)
    assert t.nbytes == 9 + 3 * 4
    with pytest.raises(ValueError, match='ndim >= 2'):
        quant.quantize_tensor(torch.ones(3))


def test_a_jax_scale_table_is_consumed_verbatim(nets, tmp_path):
    """A table written by the JAX package's ``save_scale_table`` beside a
    checkpoint (meta entries included) is read back without them and
    used for the names it holds, derived scales for the rest: the bytes
    equal the JAX package's ``transplant(..., scales=table)``."""
    sd = nets['resnet'][0]
    ckpt = tmp_path / 'resnet18.pth'
    torch.save({k: torch.from_numpy(v) for k, v in sd.items()}, ckpt)
    table = {'conv1.weight': np.full(64, 0.004, np.float32),
             'layer1.0.conv2.weight': np.linspace(0, 0.01, 64).astype(np.float32)}
    jax_quant.save_scale_table(quant.scale_table_path(str(ckpt)), table,
                               meta={'rel_l2': '1e-2'})
    loaded = quant.load_scale_table(quant.scale_table_path(str(ckpt)))
    assert loaded.keys() == table.keys()
    assert quant.load_scale_table(str(tmp_path / 'missing.npz')) == {}
    ours = flatten(lane_params(params_from_torch(sd), 'int8', str(ckpt)))
    theirs = _jax_flat(transplant(sd, dtype=np.int8, scales=loaded))
    assert np.array_equal(ours['conv1.weight'].scale.numpy().ravel(), table['conv1.weight'])
    # a zero entry becomes 1.0, as in the JAX package
    assert ours['layer1.0.conv2.weight'].scale.ravel()[0].item() == 1.0
    for k, v in ours.items():
        if isinstance(v, quant.QuantizedTensor):
            assert np.array_equal(v.q.numpy(),
                                  _torch_layout(k, np.asarray(theirs[k].q), ())), k
            assert np.array_equal(v.scale.numpy().ravel(),
                                  np.asarray(theirs[k].scale).ravel()), k
    # the extractor finds the table beside its checkpoint
    args = load_config('resnet', {'video_paths': str(ckpt), 'device': 'cpu',
                                  'model_name': 'resnet18', 'compute_dtype': 'int8',
                                  'checkpoint_path': str(ckpt),
                                  'output_path': str(tmp_path / 'out')})
    ex = create_extractor(args)
    assert torch.equal(ex.params['conv1']['weight'].scale,
                       ours['conv1.weight'].scale)


@pytest.mark.parametrize('name', ['resnet', 'clip', 'timm'])
def test_int8_features_match_the_jax_int8_lane(nets, name):
    """Both packages dequantize the same int8 bytes: rel L2 ≤ 1e-5; the
    lane differs from the port's float32 lane, within the JAX package's
    bound; features are float32."""
    sd, no_transpose, step, jax_step, x = nets[name]
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_step(transplant(sd, no_transpose=set(no_transpose),
                                             dtype=np.int8), jnp.asarray(x)))
    fp32 = params_from_torch(sd)
    with torch.inference_mode():
        got = step(lane_params(fp32, 'int8', no_transpose=no_transpose),
                   torch.from_numpy(x)).numpy()
        base = step(fp32, torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == ref.shape
    assert rel_l2(ref, got) <= REL_L2
    assert 0 < rel_l2(base, got) <= INT8_REL_L2_BOUNDS[name]


def test_the_extractor_holds_int8_params_and_emits_float32(tmp_path):
    args = load_config('resnet', {'video_paths': str(tmp_path / 'v.mp4'),
                                  'device': 'cpu', 'model_name': 'resnet18',
                                  'compute_dtype': 'int8',
                                  'allow_random_weights': True,
                                  'output_path': str(tmp_path / 'out')})
    ex = create_extractor(args)
    assert isinstance(ex.params['fc']['weight'], quant.QuantizedTensor)
    assert ex.params['bn1']['weight'].dtype == torch.float32
    frames = np.random.RandomState(0).randint(0, 256, (2, 64, 64, 3)).astype(np.uint8)
    out = ex.run_step(frames)['resnet']
    assert out.dtype == np.float32 and out.shape == (2, 512)
    with torch.inference_mode():
        want = resnet_ex.resnet_step(ex.params, torch.from_numpy(frames),
                                     'resnet18').numpy()
    assert np.array_equal(out, want)
