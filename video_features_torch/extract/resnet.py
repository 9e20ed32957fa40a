"""ResNet frame-wise extractor (port of ``video_features_tpu/extract/
resnet.py``).

torchvision's IMAGENET1K_V1 preset: short-side resize 256 (232 for
resnext101_64x4d) on the host with PIL bilinear, center crop 224, then
on the device [0, 1] → normalize → the backbone's pooled features.
``show_pred`` prints each frame's ImageNet-1k top-5 from ``fc``.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from video_features_torch.extract.framewise import BaseFrameWiseExtractor
from video_features_torch.models import resnet as resnet_model
from video_features_torch.ops.nn import linear
from video_features_torch.ops.precision import features_to_f32
from video_features_torch.ops.quant import dequantize_tree
from video_features_torch.ops.transforms import normalize, to_float_zero_one
from video_features_torch.transplant import float32_params, to_device

RESIZE_SIZE = 256
CROP_SIZE = 224
# the IMAGENET1K_V1 recipe of resnext101_64x4d resizes to 232
RESIZE_OVERRIDES = {'resnext101_64x4d': 232}


def resnet_step(params, frames: torch.Tensor, arch: str,
                dtype: torch.dtype = torch.float32,
                three_pass_convs: bool = False) -> torch.Tensor:
    """(B, H, W, 3) uint8 → (B, feat_dim) float32: [0, 1] in ``dtype``
    (the lane's activations) → normalize → ResNet, every convolution in
    3xTF32 under ``three_pass_convs``; int8 weights are dequantized
    first."""
    x = normalize(to_float_zero_one(frames, dtype), resnet_model.MEAN,
                  resnet_model.STD)
    return features_to_f32(resnet_model.forward(
        dequantize_tree(params), x, arch=arch, features=True,
        three_pass_convs=three_pass_convs))


class ExtractResNet(BaseFrameWiseExtractor):

    def __init__(self, args) -> None:
        self.model_name = args.get('model_name', 'resnet50')
        cfg = resnet_model.arch_def(self.model_name)
        super().__init__(args, feat_dim=cfg['feat_dim'])
        self.params = to_device(self.load_params(args), self.device)
        if self.data_parallel:
            self._ensure_mesh('batch_size')

    def load_params(self, args):
        from video_features_torch.extract.weights import load_or_init
        return load_or_init(
            args, 'checkpoint_path',
            partial(resnet_model.init_state_dict, arch=self.model_name),
            feature_type='resnet', what=f'resnet ({self.model_name})',
            compute_dtype=self.compute_dtype)

    def host_transform_spec(self):
        return ('edge_resize_crop',
                RESIZE_OVERRIDES.get(self.model_name, RESIZE_SIZE), CROP_SIZE,
                'bilinear')

    def step_program(self):
        return resnet_step, dict(arch=self.model_name, dtype=self.act_dtype,
                                 three_pass_convs=self.three_pass_convs)

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        """Each frame's ImageNet-1k top-5 from ``fc`` on its features."""
        from video_features_torch.utils.preds import show_predictions_on_dataset
        with torch.inference_mode(), self.precision_scope():
            logits = linear(torch.from_numpy(feats).to(self.device),
                            float32_params(self.params['fc'])).cpu().numpy()
        show_predictions_on_dataset(logits, 'imagenet1k')
