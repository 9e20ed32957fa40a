"""The port's CLIP family (video_features_torch/models/clip.py,
extract/clip.py, utils/clip_tokenizer.py and the CLI around them)
against the JAX package's, on the CPU."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tools.make_sample_video import write_noise_clip
from video_features_tpu.extract.clip import ExtractCLIP as JaxExtractCLIP
from video_features_tpu.models import clip as jax_clip
from video_features_tpu.transplant.torch2jax import save_transplanted, transplant
from video_features_torch.extract import clip as extract
from video_features_torch.models import clip
from video_features_torch.transplant import (
    load_checkpoint, nest, params_from_jax, params_from_torch,
)

REL_L2 = 1e-5       # float32 through the towers, different sum orders
CLI_REL_L2 = 1e-3   # the BASELINE feature bar
VOCAB = 512         # init_state_dict's reduced text vocabulary


def rel_l2(got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    return float(np.linalg.norm(got - ref) / np.linalg.norm(ref))


def leaves(tree, prefix=''):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from leaves(v, f'{prefix}{k}.')
        else:
            yield f'{prefix}{k}', v


@pytest.fixture(autouse=True)
def one_thread():
    """oneDNN's multi-threaded fp32 convolution can put ~4e-5 of error in
    one thread's chunk of the output; one thread holds 1e-5."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def rn50_state_dict(seed: int, grid: int) -> dict:
    """A seeded OpenAI-layout RN50 visual tower (ModifiedResNet: width 64,
    layers 3-4-6-3, 32 heads, output 1024) whose AttentionPool2d
    positional embedding is sized for grid×grid+1 tokens."""
    rng = np.random.RandomState(seed)
    sd = {}

    def conv_w(name, o, i, k):
        sd[name] = (rng.randn(o, i, k, k) * np.sqrt(1.0 / (i * k * k))
                    ).astype(np.float32)

    def bn(name, c):
        sd[f'{name}.weight'] = (rng.rand(c) * 0.5 + 0.5).astype(np.float32)
        sd[f'{name}.bias'] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[f'{name}.running_mean'] = (rng.randn(c) * 0.1).astype(np.float32)
        sd[f'{name}.running_var'] = (rng.rand(c) + 0.5).astype(np.float32)

    width, embed, out_dim = 64, 2048, 1024
    conv_w('visual.conv1.weight', width // 2, 3, 3)
    bn('visual.bn1', width // 2)
    conv_w('visual.conv2.weight', width // 2, width // 2, 3)
    bn('visual.bn2', width // 2)
    conv_w('visual.conv3.weight', width, width // 2, 3)
    bn('visual.bn3', width)
    inplanes = width
    for li, (nb, planes) in enumerate(zip((3, 4, 6, 3),
                                          (width, 2 * width, 4 * width, 8 * width)), 1):
        for bi in range(nb):
            base = f'visual.layer{li}.{bi}'
            stride = 2 if (li > 1 and bi == 0) else 1
            conv_w(f'{base}.conv1.weight', planes, inplanes, 1)
            bn(f'{base}.bn1', planes)
            conv_w(f'{base}.conv2.weight', planes, planes, 3)
            bn(f'{base}.bn2', planes)
            conv_w(f'{base}.conv3.weight', planes * 4, planes, 1)
            bn(f'{base}.bn3', planes * 4)
            if stride > 1 or inplanes != planes * 4:
                conv_w(f'{base}.downsample.0.weight', planes * 4, inplanes, 1)
                bn(f'{base}.downsample.1', planes * 4)
            inplanes = planes * 4
    sd['visual.attnpool.positional_embedding'] = (
        rng.randn(grid * grid + 1, embed) / embed ** 0.5).astype(np.float32)
    for name, o in (('q_proj', embed), ('k_proj', embed), ('v_proj', embed),
                    ('c_proj', out_dim)):
        sd[f'visual.attnpool.{name}.weight'] = (
            rng.randn(o, embed) / embed ** 0.5).astype(np.float32)
        sd[f'visual.attnpool.{name}.bias'] = (rng.randn(o) * 0.02).astype(np.float32)
    return sd


def reduced_vocab_tokens(seed: int, rows: int) -> np.ndarray:
    """(rows, 77) token ids as the JAX package's zero-shot golden maps
    real prompts into the reduced vocabulary: content ids in [1, 510),
    the end-of-text token (the row's largest id) 511, zeros after it.
    Row 0 holds the end-of-text token alone (all later positions pad)."""
    rng = np.random.RandomState(seed)
    tokens = np.zeros((rows, 77), np.int64)
    for r in range(rows):
        n = 0 if r == 0 else rng.randint(1, 20)
        tokens[r, :n] = rng.randint(1, 510, n)
        tokens[r, n] = VOCAB - 1
    return tokens


@pytest.fixture(scope='module')
def towers():
    """ViT-B/32 (resblocks cut to 2, text tower 2 layers) and RN50 at 64
    px, each as JAX params and port params from one state_dict."""
    sd = jax_clip.init_state_dict(seed=0)
    mine = clip.init_state_dict(seed=0)
    assert sd.keys() == mine.keys()
    assert all(np.array_equal(sd[k], mine[k]) for k in sd)
    vit = {k: v for k, v in sd.items()
           if not (k.startswith('visual.transformer.resblocks.')
                   and int(k.split('.')[3]) >= 2)}
    rn = rn50_state_dict(seed=1, grid=2)
    out = {}
    for name, state in (('vit', vit), ('rn', rn)):
        jp = transplant(state, no_transpose=set(jax_clip.NO_TRANSPOSE))
        out[name] = (jp, params_from_torch(state), state)
    return out


def _image(seed, size):
    return np.random.RandomState(seed).randn(2, size, size, 3).astype(np.float32)


@pytest.mark.parametrize('tower,model_name,size', [('vit', 'ViT-B/32', 224),
                                                   ('rn', 'RN50', 64)])
def test_visual_tower_matches_jax(towers, tower, model_name, size):
    """The ViT tower (class token, ln_pre/ln_post, the raw ``proj``) and
    the ModifiedResNet tower (3-conv stem, anti-aliased striding,
    AttentionPool2d with its (O, I) projections as F.linear weights)."""
    jp, tp, _ = towers[tower]
    x = _image(size, size)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(jax_clip.encode_image(jp, jnp.asarray(x), model_name))
    with torch.inference_mode():
        got = clip.encode_image(tp, torch.from_numpy(x), model_name).numpy()
    assert got.shape == ref.shape == (2, clip.VISUAL_CFGS[model_name]['embed_dim'])
    assert rel_l2(got, ref) <= REL_L2


def test_step_matches_the_jax_extractor_step(towers):
    """uint8 frames → [0, 1] → normalize (CLIP's mean and std) →
    encode_image, against the JAX extractor's step function."""
    jp, tp, _ = towers['vit']
    frames = np.random.RandomState(3).randint(0, 256, (2, 224, 224, 3)).astype(np.uint8)
    with jax.default_matmul_precision('highest'):
        ref = np.asarray(JaxExtractCLIP._forward(jp, jnp.asarray(frames),
                                                 arch='ViT-B/32'))
    with torch.inference_mode():
        got = extract.clip_step(tp, torch.from_numpy(frames), 'ViT-B/32').numpy()
    assert rel_l2(got, ref) <= REL_L2


def test_text_tower_and_zero_shot_logits_match_jax(towers):
    """The causal text tower pooled at the end-of-text token, on
    reduced-vocab ids, and the temperature-scaled cosine logits; the
    -inf mask leaves no NaN, even on a row of padding."""
    jp, tp, _ = towers['vit']
    tokens = reduced_vocab_tokens(4, 6)
    img = np.random.RandomState(5).randn(3, 512).astype(np.float32)
    with jax.default_matmul_precision('highest'):
        ref_txt = jax_clip.encode_text(jp, jnp.asarray(tokens), 'ViT-B/32')
        ref_logits = np.asarray(jax_clip.zero_shot_logits(jp, jnp.asarray(img),
                                                          ref_txt))
    with torch.inference_mode():
        txt = clip.encode_text(tp, torch.from_numpy(tokens))
        logits = clip.zero_shot_logits(tp, torch.from_numpy(img), txt).numpy()
    assert txt.shape == (6, 512) and torch.isfinite(txt).all()
    assert rel_l2(txt.numpy(), np.asarray(ref_txt)) <= REL_L2
    assert logits.shape == (3, 6) and rel_l2(logits, ref_logits) <= REL_L2


def test_quick_gelu_and_layer_norm_match_jax():
    x = np.random.RandomState(6).randn(4, 7, 96).astype(np.float32) * 3
    p = {'weight': np.random.RandomState(7).rand(96).astype(np.float32) + 0.5,
         'bias': np.random.RandomState(8).randn(96).astype(np.float32)}
    ref = np.asarray(jax_clip.layer_norm(jnp.asarray(x), p))
    got = clip.layer_norm(torch.from_numpy(x),
                          {k: torch.from_numpy(v) for k, v in p.items()}).numpy()
    assert np.abs(got - ref).max() <= 1e-5
    ref = np.asarray(jax_clip.quick_gelu(jnp.asarray(x)))
    assert np.abs(clip.quick_gelu(torch.from_numpy(x)).numpy() - ref).max() <= 1e-6


class _Shape:
    """A weight's shape alone, for the arch-inference tests."""

    def __init__(self, *shape):
        self.shape = shape


def _shape_state_dict(model_name: str) -> dict:
    """The keys and shapes that arch inference reads, for one arch."""
    cfg = clip.VISUAL_CFGS[model_name]
    sd = {}
    if cfg['kind'] == 'vit':
        w, p = cfg['width'], cfg['patch']
        grid = cfg['input_resolution'] // p
        sd['visual.proj'] = (w, cfg['embed_dim'])
        sd['visual.conv1.weight'] = (w, 3, p, p)
        sd['visual.positional_embedding'] = (grid * grid + 1, w)
        for i in range(cfg['layers']):
            sd[f'visual.transformer.resblocks.{i}.ln_1.weight'] = (w,)
        return sd
    inplanes, width = cfg['width'], cfg['width']
    for li, nb in enumerate(cfg['layers'], start=1):
        planes = width * 2 ** (li - 1)
        for bi in range(nb):
            sd[f'visual.layer{li}.{bi}.conv1.weight'] = (planes, inplanes, 1, 1)
            inplanes = planes * 4
    return sd


@pytest.mark.parametrize('model_name', list(jax_clip.VISUAL_CFGS))
def test_infer_model_name_matches_jax(model_name):
    """From a state_dict (torch layout) and from a params tree (the
    port's torch layout, the JAX package's transposed one) on all nine
    arches."""
    shapes = _shape_state_dict(model_name)
    torch_sd = {k: torch.empty(s, device='meta') for k, s in shapes.items()}
    jax_sd = {k: _Shape(*s) for k, s in shapes.items()}

    def hwio(k, s):
        if k.endswith('.weight') and len(s) == 4:
            return _Shape(*s[2:], s[1], s[0])
        return _Shape(*s)
    jax_params = nest({k: hwio(k, s) for k, s in shapes.items()})
    assert clip.infer_model_name(torch_sd) == model_name
    assert clip.infer_model_name_from_params(nest(torch_sd)) == model_name
    assert jax_clip.infer_model_name(jax_sd) == model_name
    assert jax_clip.infer_model_name_from_params(jax_params) == model_name


def test_npz_path_keeps_the_embedding_table(towers, tmp_path):
    """A JAX-transplanted .npz through load_checkpoint with no_transpose
    gives the port the params it builds from the state_dict, leaf for
    leaf; without no_transpose the (512, 512) token table comes back
    transposed, a silent error the shapes cannot catch."""
    jp, tp, _ = towers['vit']
    save_transplanted(jp, str(tmp_path / 'vit.npz'))
    got = dict(leaves(load_checkpoint(str(tmp_path / 'vit.npz'),
                                      no_transpose=clip.NO_TRANSPOSE)))
    want = dict(leaves(tp))
    assert got.keys() == want.keys()
    assert all(torch.equal(got[k], want[k]) for k in want)
    plain = params_from_jax(jp)['token_embedding']['weight']
    assert plain.shape == want['token_embedding.weight'].shape
    assert not torch.equal(plain, want['token_embedding.weight'])


def test_random_init_is_vit_only(tmp_path):
    with pytest.raises(NotImplementedError, match='ViT'):
        clip.init_state_dict(model_name='RN50')
    with pytest.raises(ValueError, match='ViT-L/14@336px'):
        extract.load_params({'model_name': 'ViT-H/14', 'allow_random_weights': True})


def test_bpe_tokenizer_matches_jax():
    from video_features_torch.utils.clip_tokenizer import find_bpe_vocab, tokenize
    if find_bpe_vocab() is None:
        pytest.skip('CLIP BPE vocab unavailable ($VFT_CLIP_BPE)')
    from video_features_tpu.utils.clip_tokenizer import tokenize as jax_tokenize
    texts = ['a photo of archery', 'playing guitar!', "it's 3 o'clock"]
    assert np.array_equal(tokenize(texts), jax_tokenize(texts))


def _save_custom_checkpoint(directory):
    """OpenAI's custom layout: a ViT-B/32 state_dict of fp16 tensors at
    ./checkpoints/CLIP-custom.pth."""
    sd = jax_clip.init_state_dict(seed=2)
    (directory / 'checkpoints').mkdir()
    path = directory / 'checkpoints' / 'CLIP-custom.pth'
    torch.save({k: torch.from_numpy(np.asarray(v)).half() for k, v in sd.items()},
               path)
    return path


def test_cli_custom_matches_jax_cli(tmp_path, monkeypatch):
    """Both CLIs with model_name=custom and no checkpoint_path load the
    implicit ./checkpoints/CLIP-custom.pth (fp16, upcast), infer ViT-B/32
    and write clip/custom/<stem>_clip.npy within the bar, _fps.npy and
    _timestamps_ms.npy identical."""
    from video_features_tpu.cli import main as jax_main
    from video_features_torch.cli import main as torch_main
    monkeypatch.chdir(tmp_path)
    _save_custom_checkpoint(tmp_path)
    clip_path = write_noise_clip(tmp_path / 'clip.mp4', 5, seed=9)
    common = [f'video_paths={clip_path}', 'device=cpu', 'model_name=custom',
              'batch_size=4', 'on_extraction=save_numpy']
    assert jax_main(['feature_type=clip', *common, 'decode_backend=cv2',
                     f'output_path={tmp_path / "jax"}',
                     f'tmp_path={tmp_path / "jax_tmp"}']) == 0
    assert torch_main(['feature_type=clip', *common,
                       f'output_path={tmp_path / "torch"}',
                       f'tmp_path={tmp_path / "torch_tmp"}']) == 0
    out = {side: tmp_path / side / 'clip' / 'custom' for side in ('jax', 'torch')}
    ref, got = (np.load(out[s] / 'clip_clip.npy') for s in ('jax', 'torch'))
    assert got.shape == ref.shape == (5, 512)
    assert rel_l2(got, ref) <= CLI_REL_L2
    for key in ('fps', 'timestamps_ms'):
        assert np.array_equal(np.load(out['torch'] / f'clip_{key}.npy'),
                              np.load(out['jax'] / f'clip_{key}.npy'))
