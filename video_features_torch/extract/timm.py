"""timm-style image-backbone extractor (port of ``video_features_tpu/
extract/timm.py``).

A registry of native backbones in timm's state_dict layout: ViT and
DeiT (distilled DeiT included), ResNet, ConvNeXt, Swin, EfficientNet,
RegNet, MobileNetV3, BEiT and MLP-Mixer. A ``model_name`` resolves by
its tail, so an hf-hub id (``hf_hub:timm/vit_base_patch16_224.
augreg_in21k``) names ``vit_base_patch16_224``; a name outside the
registry is refused, listing it.

Per frame: a PIL edge resize to ``int(crop / crop_pct)`` with the
family's interpolation and a center crop on the host (timm's
``resolve_data_config``), then on the device [0, 1] → normalize → the
backbone's features. ``image_size`` overrides the crop (and scales the
resize to keep crop_pct); a ViT/DeiT resamples its pos embed to the
larger patch grid, and from 2048 tokens on its attention runs blockwise.
BEiT and Mixer refuse it. ``sequence_parallel=true`` (ViT/DeiT, float32
only) splits each frame's tokens over every local device and runs
attention as a ring over them.

Weights: ``checkpoint_path`` (``.pt``/``.pth``/``.npz``) or the gated
random init. Unlike the JAX package, the port never imports pip
``timm``, so ``pretrained=true`` downloads nothing: without a checkpoint
the run fails with ``MissingCheckpointError`` unless random weights are
allowed.
"""
from __future__ import annotations

from functools import partial
from typing import Any, Dict, Sequence

import numpy as np
import torch

from video_features_torch.extract.framewise import BaseFrameWiseExtractor
from video_features_torch.models import beit as beit_model
from video_features_torch.models import convnext as convnext_model
from video_features_torch.models import efficientnet as efficientnet_model
from video_features_torch.models import mixer as mixer_model
from video_features_torch.models import mobilenetv3 as mobilenetv3_model
from video_features_torch.models import regnet as regnet_model
from video_features_torch.models import resnet as resnet_model
from video_features_torch.models import swin as swin_model
from video_features_torch.models import vit as vit_model
from video_features_torch.ops.nn import linear
from video_features_torch.ops.precision import features_to_f32
from video_features_torch.ops.quant import dequantize_tree
from video_features_torch.ops.transforms import normalize, to_float_zero_one
from video_features_torch.transplant import float32_params, to_device


def _data_cfg(family: str, arch: str = '') -> Dict[str, Any]:
    """timm ``resolve_data_config`` for the native families: resize =
    int(input_size / crop_pct), the family's interpolation and stats."""
    if family == 'efficientnet':
        # per-arch input sizes (timm efficientnet default_cfgs)
        _, _, size, crop_pct = efficientnet_model.ARCHS[arch]
        return dict(resize=int(size / crop_pct), crop=size,
                    interpolation='bicubic',
                    mean=efficientnet_model.MEAN, std=efficientnet_model.STD)
    if family == 'vit':
        # timm vit: crop_pct 0.9, bicubic, 0.5 "inception" stats
        return dict(resize=248, crop=224, interpolation='bicubic',
                    mean=vit_model.MEAN, std=vit_model.STD)
    if family == 'beit':
        # timm beit: same recipe as vit (crop_pct 0.9, bicubic, 0.5 stats)
        return dict(resize=248, crop=224, interpolation='bicubic',
                    mean=beit_model.MEAN, std=beit_model.STD)
    if family == 'mixer':
        # timm mixer _cfg: crop_pct 0.875, bicubic, 0.5 stats
        return dict(resize=256, crop=224, interpolation='bicubic',
                    mean=mixer_model.MEAN, std=mixer_model.STD)
    if family == 'deit':
        # timm deit _cfg: crop_pct 0.9, bicubic, ImageNet stats
        return dict(resize=248, crop=224, interpolation='bicubic',
                    mean=convnext_model.MEAN, std=convnext_model.STD)
    if family == 'convnext':
        # timm convnext default_cfg: crop_pct 0.875, bicubic, ImageNet stats
        return dict(resize=256, crop=224, interpolation='bicubic',
                    mean=convnext_model.MEAN, std=convnext_model.STD)
    if family == 'swin':
        # timm swin default_cfg: crop_pct 0.9, bicubic, ImageNet stats
        return dict(resize=248, crop=224, interpolation='bicubic',
                    mean=swin_model.MEAN, std=swin_model.STD)
    if family == 'regnet':
        # timm regnet _cfg: crop_pct 0.875, bicubic, ImageNet stats
        return dict(resize=256, crop=224, interpolation='bicubic',
                    mean=regnet_model.MEAN, std=regnet_model.STD)
    # resnet and mobilenetv3 share timm's default recipe: crop_pct 0.875,
    # bilinear, ImageNet stats
    return dict(resize=256, crop=224, interpolation='bilinear',
                mean=resnet_model.MEAN, std=resnet_model.STD)


def _registry() -> Dict[str, Dict[str, Any]]:
    reg = {}
    for name, cfg in vit_model.ARCHS.items():
        reg[name] = dict(family='vit', arch=name, feat_dim=cfg['width'])
    # non-distilled DeiT is timm's VisionTransformer (only the data config
    # differs); the distilled variants add dist_token / head_dist, and
    # models/vit.py follows the checkpoint's dist_token
    for deit, vit_arch in [
        ('deit_tiny_patch16_224', 'vit_tiny_patch16_224'),
        ('deit_small_patch16_224', 'vit_small_patch16_224'),
        ('deit_base_patch16_224', 'vit_base_patch16_224'),
    ]:
        reg[deit] = dict(family='deit', arch=vit_arch,
                         feat_dim=vit_model.ARCHS[vit_arch]['width'])
        dist = deit.replace('_patch', '_distilled_patch')
        reg[dist] = dict(family='deit', arch=vit_arch,
                         feat_dim=vit_model.ARCHS[vit_arch]['width'],
                         init=dict(distilled=True))
    for name, cfg in resnet_model.ARCHS.items():
        reg[name] = dict(family='resnet', arch=name, feat_dim=cfg['feat_dim'])
    for name, cfg in convnext_model.ARCHS.items():
        reg[name] = dict(family='convnext', arch=name,
                         feat_dim=cfg['dims'][-1])
    for name in swin_model.ARCHS:
        reg[name] = dict(family='swin', arch=name,
                         feat_dim=swin_model.feat_dim(name))
    for name in efficientnet_model.ARCHS:
        reg[name] = dict(family='efficientnet', arch=name,
                         feat_dim=efficientnet_model.feat_dim(name))
    for name in regnet_model.ARCHS:
        reg[name] = dict(family='regnet', arch=name,
                         feat_dim=regnet_model.feat_dim(name))
    for name in mobilenetv3_model.ARCHS:
        reg[name] = dict(family='mobilenetv3', arch=name,
                         feat_dim=mobilenetv3_model.feat_dim(name))
    for name in beit_model.ARCHS:
        reg[name] = dict(family='beit', arch=name,
                         feat_dim=beit_model.feat_dim(name))
    for name in mixer_model.ARCHS:
        reg[name] = dict(family='mixer', arch=name,
                         feat_dim=mixer_model.feat_dim(name))
    return reg


REGISTRY = _registry()

# family → model module (deit shares the vit graph)
MODEL_MODULES = {'vit': vit_model, 'deit': vit_model,
                 'resnet': resnet_model, 'convnext': convnext_model,
                 'swin': swin_model, 'efficientnet': efficientnet_model,
                 'regnet': regnet_model, 'mobilenetv3': mobilenetv3_model,
                 'beit': beit_model, 'mixer': mixer_model}


def resolve_model_name(model_name: str) -> Dict[str, Any]:
    """The registry entry of ``model_name``, resolved by its tail
    (``hf_hub:timm/<name>.<tag>`` → ``<name>``); an unknown name raises
    ``NotImplementedError`` listing the registry."""
    name = str(model_name).split(':')[-1].split('/')[-1].split('.')[0]
    if name not in REGISTRY:
        raise NotImplementedError(
            f'model_name {model_name!r} is not in the native backbone '
            f'registry: {", ".join(sorted(REGISTRY))}')
    return REGISTRY[name]


def timm_step(params, frames: torch.Tensor, family: str, arch: str,
              mean: Sequence[float], std: Sequence[float],
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, feat_dim) float32: [0, 1] in ``dtype``
    (the lane's activations) → normalize → the family's
    ``forward(features=True)``; int8 weights are dequantized first."""
    x = normalize(to_float_zero_one(frames, dtype), mean, std)
    return features_to_f32(MODEL_MODULES[family].forward(
        dequantize_tree(params), x, arch=arch, features=True))


class ExtractTIMM(BaseFrameWiseExtractor):

    def __init__(self, args) -> None:
        self.model_name = args['model_name']
        spec = resolve_model_name(self.model_name)
        self.family, self.arch = spec['family'], spec['arch']
        image_size = args.get('image_size')
        if image_size and self.family in ('beit', 'mixer'):
            raise NotImplementedError(
                f'image_size override is not supported for {self.family}: '
                f'its weights are tied to the checkpoint resolution (224): '
                f'BEiT through the relative-position-bias tables, Mixer '
                f'through the token-mix MLP width. Use a ViT/DeiT model for '
                f'high-resolution inputs.')
        self.data_cfg = _data_cfg(self.family, self.arch)
        if image_size:
            image_size = int(image_size)
            if self.family in ('vit', 'deit'):
                patch = vit_model.ARCHS[self.arch]['patch']
                if image_size % patch:
                    raise ValueError(
                        f'image_size={image_size} must be a multiple of the '
                        f'patch size ({patch}) for {self.arch}')
            factor = image_size / self.data_cfg['crop']
            self.data_cfg['resize'] = int(round(self.data_cfg['resize'] * factor))
            self.data_cfg['crop'] = image_size
        super().__init__(args, feat_dim=spec['feat_dim'])
        # sequence_parallel (ViT/DeiT only): each frame's tokens split over
        # every local device, attention a ring over them (models/vit.py::
        # forward_sequence_parallel); refused before the weights load
        self.sequence_parallel = bool(args.get('sequence_parallel', False))
        if self.sequence_parallel:
            if self.compute_dtype != 'float32':
                raise NotImplementedError(
                    'sequence_parallel + compute_dtype=bfloat16 is not '
                    'supported: the ring-attention kernel\'s online-'
                    'softmax accumulators are tuned fp32 end to end '
                    '(ops/attention.py) and have no measured bf16 parity '
                    'bound — run the fast lane on the standard path, or '
                    'sequence-parallel at float32')
            if self.family not in ('vit', 'deit'):
                raise NotImplementedError(
                    'sequence_parallel is implemented for the ViT/DeiT '
                    f'families (attention over tokens); {self.family} has '
                    'no token axis to shard')
            if self.data_parallel:
                raise NotImplementedError(
                    'sequence_parallel claims every local device for the '
                    'token axis; combine with data parallelism across '
                    'hosts (multihost=true), not data_parallel=true')
        self.params = to_device(self.load_params(args, spec.get('init', {})),
                                self.device)
        self._seq_replicas = None
        if self.sequence_parallel:
            from video_features_torch.parallel.mesh import make_mesh, move
            from video_features_torch.utils.device import local_devices
            devices = local_devices(self.device)
            # the data axis is 1: each batch goes to this extractor's device
            self._mesh = make_mesh(devices=devices, time_parallel=len(devices))
            self._seq_replicas = [move(self.params, d) for d in devices]
        if self.data_parallel:
            self._ensure_mesh('batch_size')

    def load_params(self, args, init_kwargs: Dict[str, Any]):
        from video_features_torch.extract.weights import load_or_init
        module = MODEL_MODULES[self.family]
        return load_or_init(
            args, 'checkpoint_path',
            partial(module.init_state_dict, arch=self.arch, **init_kwargs),
            feature_type='timm', what=f'timm ({self.model_name})',
            compute_dtype=self.compute_dtype)

    def host_transform_spec(self):
        return ('edge_resize_crop', self.data_cfg['resize'],
                self.data_cfg['crop'], self.data_cfg['interpolation'])

    def device_step(self, frames: torch.Tensor) -> torch.Tensor:
        if self._seq_replicas is not None:
            x = normalize(to_float_zero_one(frames), self.data_cfg['mean'],
                          self.data_cfg['std'])
            return vit_model.forward_sequence_parallel(
                self.params, x, self._mesh, arch=self.arch,
                replicas=self._seq_replicas)
        return timm_step(self.params, frames, self.family, self.arch,
                         self.data_cfg['mean'], self.data_cfg['std'],
                         self.act_dtype)

    def classifier(self):
        """The family's classifier params, or None: ``head`` (ViT, BEiT,
        Mixer), ``head.fc`` (ConvNeXt, Swin, RegNet), ``classifier``
        (EfficientNet, MobileNetV3), ``fc`` (ResNet)."""
        if self.family in ('vit', 'deit', 'beit', 'mixer'):
            return self.params.get('head')
        if self.family in ('convnext', 'swin', 'regnet'):
            return (self.params.get('head') or {}).get('fc')
        if self.family in ('efficientnet', 'mobilenetv3'):
            return self.params.get('classifier')
        return self.params.get('fc')

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        """Each frame's ImageNet-1k top-5 from the family's classifier;
        nothing when the checkpoint has none. Distilled DeiT prints why it
        skips: its logits need the separate cls and dist tokens."""
        if 'dist_token' in self.params:
            print('show_pred: distilled DeiT logits need the separate '
                  'cls/dist tokens (timm deit.py); skipping the top-5 '
                  'table for pooled features')
            return
        head = self.classifier()
        if not head:
            return
        from video_features_torch.utils.preds import show_predictions_on_dataset
        with torch.inference_mode(), self.precision_scope():
            logits = linear(torch.from_numpy(feats).to(self.device),
                            float32_params(head))
        show_predictions_on_dataset(logits.cpu().numpy(), 'imagenet1k')
