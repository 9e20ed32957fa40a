"""``show_pred`` of the port's r21d, s3d, i3d, resnet, clip and timm
extractors: the stdout table (``At frames (a, b)`` / ``At stack k
(stream)``, then the Kinetics, ImageNet-1k or zero-shot top-5) against
the JAX package's where it prints the same thing, on the CPU; and the
i3d surface's two deliberate divergences from it."""
import numpy as np
import pytest
import torch

from video_features_tpu.config import load_config as jax_load_config
from video_features_tpu.registry import create_extractor as jax_create
from video_features_torch.extract import clip, i3d, r21d, resnet, s3d, timm
from video_features_torch.models import i3d as i3d_model
from video_features_torch.models import raft as raft_model
from video_features_torch.utils.preds import load_label_map

LOGIT_ATOL = 1e-3   # the table prints three decimals


def table(text):
    """(headers, [(logit, prob, label), ...]) of show_pred's stdout."""
    heads, rows = [], []
    for line in text.splitlines():
        if line.startswith('At '):
            heads.append(line)
        elif line.count('|') == 2 and 'Logits' not in line:
            logit, prob, label = (part.strip() for part in line.split('|'))
            rows.append((float(logit), float(prob), label))
    return heads, rows


def assert_same_table(got, ref):
    (got_heads, got_rows), (ref_heads, ref_rows) = table(got), table(ref)
    assert got_heads == ref_heads
    assert [r[2] for r in got_rows] == [r[2] for r in ref_rows]
    np.testing.assert_allclose([r[:2] for r in got_rows],
                               [r[:2] for r in ref_rows], atol=LOGIT_ATOL)


def _args(tmp_path, feature_type, **overrides):
    args = {'feature_type': feature_type, 'device': 'cpu',
            'allow_random_weights': True, 'show_pred': True,
            'on_extraction': 'save_numpy', 'output_path': str(tmp_path / 'torch')}
    args.update(overrides)
    return args


def _jax_extractor(tmp_path, feature_type, **overrides):
    return jax_create(jax_load_config(feature_type, overrides={
        'video_paths': str(tmp_path / 'v.mp4'), 'device': 'cpu',
        'allow_random_weights': True, 'show_pred': True,
        'output_path': str(tmp_path / 'jax'), 'tmp_path': str(tmp_path / 'tmp'),
        **overrides}))


def test_kinetics_label_map_ships_with_the_package(monkeypatch):
    monkeypatch.delenv('VFT_LABEL_MAP_DIR', raising=False)
    classes = load_label_map('kinetics')
    assert len(classes) == 400 and classes[0] == 'abseiling'


def test_imagenet1k_label_map_ships_with_the_package(monkeypatch):
    from video_features_tpu.utils.preds import load_label_map as jax_load_label_map
    monkeypatch.delenv('VFT_LABEL_MAP_DIR', raising=False)
    classes = load_label_map('imagenet1k')
    assert len(classes) == 1000 and classes == jax_load_label_map('imagenet1k')


def test_r21d_table_matches_jax(tmp_path, capsys, monkeypatch):
    """``fc`` on a window's features (both packages start from the same
    seeded weights); extract_frames narrates each window's frame range."""
    ex = r21d.ExtractR21D(_args(tmp_path, 'r21d'))
    jex = _jax_extractor(tmp_path, 'r21d')
    feats = np.random.RandomState(0).randn(1, 512).astype(np.float32) * 0.1
    ex.maybe_show_pred(feats, 16, 32)
    got = capsys.readouterr().out
    jex.maybe_show_pred(feats, 16, 32)
    assert_same_table(got, capsys.readouterr().out)
    assert table(got)[0] == ['At frames (16, 32)'] and len(table(got)[1]) == 5

    monkeypatch.setattr(ex, 'packed_step', lambda stacks: {
        'r21d': torch.from_numpy(np.tile(feats, (len(stacks), 1)))})
    frames = np.zeros((33, 8, 8, 3), np.uint8)
    ex.extract_frames([(list(frames), None, None)])
    heads, rows = table(capsys.readouterr().out)
    assert heads == ['At frames (0, 16)', 'At frames (16, 32)'] and len(rows) == 10


def test_s3d_table_matches_jax(tmp_path, capsys):
    """The window recomputed through the classifier head."""
    ex = s3d.ExtractS3D(_args(tmp_path, 's3d', stack_size=16, step_size=16))
    jex = _jax_extractor(tmp_path, 's3d', stack_size=16, step_size=16)
    stacks = np.random.RandomState(1).randint(0, 256, (1, 16, 48, 64, 3)).astype(np.uint8)
    ex.maybe_show_pred(stacks, 0, 16)
    got = capsys.readouterr().out
    size, scale = s3d.resize_geometry(48, 64)
    jex.maybe_show_pred(stacks, 0, 16, size, scale)
    assert_same_table(got, capsys.readouterr().out)
    assert table(got)[0] == ['At frames (0, 16)'] and len(table(got)[1]) == 5


def test_i3d_table_per_stream_and_flow_png(tmp_path, capsys, monkeypatch):
    """Each stream's top-5 from its tower's classifier head on the window
    batch, and the first pair's flow PNG; a failed PNG write is reported
    on stderr, not raised."""
    ex = i3d.ExtractI3D(_args(tmp_path, 'i3d', stack_size=10, step_size=10,
                              raft_iters=1, batch_size=2))
    stacks = np.random.RandomState(2).randint(0, 256, (2, 11, 64, 88, 3)).astype(np.uint8)
    ex.maybe_show_pred(stacks, 4)
    heads, rows = table(capsys.readouterr().out)
    assert heads == ['At stack 4 (rgb stream)', 'At stack 4 (flow stream)']
    x = torch.from_numpy(stacks)
    pads = ex.geometry(64, 88)[1]
    with torch.inference_mode():
        inputs = {'rgb': i3d.rgb_stream_input(x, 64),
                  'flow': i3d.flow_stream_input(ex.params['raft'], x, pads, 64,
                                                raft_iters=1)}
        logits = {s: i3d_model.forward(ex.params[s], inputs[s], features=False)[1]
                  for s in ('rgb', 'flow')}
    classes = load_label_map('kinetics')
    want = [classes[k] for s in ('rgb', 'flow') for row in logits[s].numpy()
            for k in np.argsort(-row)[:5]]
    assert [r[2] for r in rows] == want
    png = tmp_path / 'torch' / 'flow_debug' / 'frames_stack_000004.png'
    assert png.stat().st_size > 0

    import cv2
    monkeypatch.setattr(cv2, 'imwrite', lambda *a: False)
    ex.maybe_show_pred(stacks[:1], 5)
    assert 'flow viz PNG not written' in capsys.readouterr().err


def test_i3d_divergences_from_the_reference_are_pinned(tmp_path, capsys, monkeypatch):
    """Two deliberate divergences of the i3d debug surface from the JAX
    package (README, port section): RAFT runs at the run's raft_iters
    (the JAX package runs its default 20), and the PNG is
    ``flow_debug/<stem>_stack_<k>.png`` (the JAX package writes
    ``stack_<k>.png``, which collides across videos)."""
    ex = i3d.ExtractI3D(_args(tmp_path, 'i3d', stack_size=10, step_size=10,
                              raft_iters=2, streams='flow'))
    ex._viz_stem = 'clip'
    iters = []
    forward = raft_model.forward_stack_pairs

    def spy(*a, iters=raft_model.ITERS, **kw):
        spy.calls.append(iters)
        return forward(*a, iters=iters, **kw)
    spy.calls = iters
    monkeypatch.setattr(raft_model, 'forward_stack_pairs', spy)
    stacks = np.random.RandomState(3).randint(0, 256, (1, 11, 64, 64, 3)).astype(np.uint8)
    ex.maybe_show_pred(stacks, 7)
    capsys.readouterr()
    assert iters and set(iters) == {2}
    debug = tmp_path / 'torch' / 'flow_debug'
    assert sorted(p.name for p in debug.iterdir()) == ['clip_stack_000007.png']


def test_resnet_table_matches_jax(tmp_path, capsys):
    """Each frame's ImageNet-1k top-5 from ``fc`` on its features (both
    packages start from the same seeded weights)."""
    ex = resnet.ExtractResNet(_args(tmp_path, 'resnet', model_name='resnet18'))
    jex = _jax_extractor(tmp_path, 'resnet', model_name='resnet18')
    feats = np.random.RandomState(4).rand(2, 512).astype(np.float32)
    ex.maybe_show_pred(feats)
    got = capsys.readouterr().out
    jex.maybe_show_pred(feats)
    assert_same_table(got, capsys.readouterr().out)
    rows = table(got)[1]
    assert len(rows) == 10 and rows[0][2] in load_label_map('imagenet1k')


def _reduced_vocab_tokenize(texts, *args, **kwargs):
    """A stand-in for the BPE tokenizer (its vocab is not in the
    repository): each text's characters as ids in [1, 510), then the
    end-of-text id 511 of the reduced test vocabulary."""
    out = np.zeros((len(texts), 77), np.int32)
    for r, text in enumerate(texts):
        ids = [ord(c) % 509 + 1 for c in text][:75]
        out[r, :len(ids)] = ids
        out[r, len(ids)] = 511
    return out


@pytest.fixture(scope='module')
def clip_pair(tmp_path_factory):
    tmp = tmp_path_factory.mktemp('clip_pred')
    texts = ['a photo of archery', 'a photo of bowling', 'a photo of surfing',
             'a photo of juggling', 'a photo of dancing', 'a photo of cooking']
    return (clip.ExtractCLIP(_args(tmp, 'clip', pred_texts=texts)),
            _jax_extractor(tmp, 'clip', pred_texts=texts))


def test_clip_zero_shot_table_matches_jax(clip_pair, capsys, monkeypatch):
    """Zero-shot top-5 against ``pred_texts``: the text features computed
    once, cosine logits at the learned temperature."""
    from video_features_torch.utils import clip_tokenizer
    from video_features_tpu.utils import clip_tokenizer as jax_clip_tokenizer
    ex, jex = clip_pair
    monkeypatch.setattr(clip_tokenizer, 'tokenize', _reduced_vocab_tokenize)
    monkeypatch.setattr(jax_clip_tokenizer, 'tokenize', _reduced_vocab_tokenize)
    feats = np.random.RandomState(5).randn(2, 512).astype(np.float32)
    ex.maybe_show_pred(feats)
    got = capsys.readouterr().out
    jex.maybe_show_pred(feats)
    assert_same_table(got, capsys.readouterr().out)
    assert len(table(got)[1]) == 10
    cached = ex.text_features()[0]
    assert ex.text_features()[0] is cached


def test_clip_without_the_bpe_vocab_degrades(clip_pair, capsys, monkeypatch, tmp_path):
    """No vocab: ``show_pred unavailable: …`` as the JAX package prints
    it, and extraction goes on."""
    from video_features_torch.utils import clip_tokenizer
    monkeypatch.setenv('VFT_CLIP_BPE', str(tmp_path / 'missing.txt.gz'))
    assert clip_tokenizer.find_bpe_vocab() is None
    ex = clip.ExtractCLIP(_args(tmp_path, 'clip'))
    ex.maybe_show_pred(np.ones((1, 512), np.float32))
    out = capsys.readouterr().out
    assert out.startswith('show_pred unavailable: CLIP BPE vocab not found')


def test_imagenet21k_label_map_ships_with_the_package(monkeypatch):
    monkeypatch.delenv('VFT_LABEL_MAP_DIR', raising=False)
    from video_features_tpu.utils.preds import load_label_map as jax_load_label_map
    classes = load_label_map('imagenet21k')
    assert len(classes) > 20000 and classes == jax_load_label_map('imagenet21k')


def test_timm_table_matches_jax(tmp_path, capsys):
    """timm's ImageNet-1k top-5 through the family's head (ConvNeXt:
    ``head.fc``), both packages from the same seeded weights."""
    ex = timm.ExtractTIMM(_args(tmp_path, 'timm', model_name='convnext_tiny'))
    jex = _jax_extractor(tmp_path, 'timm', model_name='convnext_tiny',
                         pretrained=False)
    feats = np.random.RandomState(6).randn(2, 768).astype(np.float32)
    ex.maybe_show_pred(feats)
    got = capsys.readouterr().out
    jex.maybe_show_pred(feats)
    assert_same_table(got, capsys.readouterr().out)
    rows = table(got)[1]
    assert len(rows) == 10 and rows[0][2] in load_label_map('imagenet1k')


def test_timm_distilled_deit_prints_why_it_skips(tmp_path, capsys):
    """Distilled DeiT's logits need the separate cls and dist tokens: both
    packages print the same reason and no table."""
    name = 'deit_tiny_distilled_patch16_224'
    ex = timm.ExtractTIMM(_args(tmp_path, 'timm', model_name=name))
    jex = _jax_extractor(tmp_path, 'timm', model_name=name, pretrained=False)
    feats = np.ones((1, 192), np.float32)
    ex.maybe_show_pred(feats)
    got = capsys.readouterr().out
    jex.maybe_show_pred(feats)
    assert got == capsys.readouterr().out
    assert got.startswith('show_pred: distilled DeiT logits') and not table(got)[1]
