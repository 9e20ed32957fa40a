"""R(2+1)D extractor (port of ``video_features_tpu/extract/r21d.py``).

  * frames stream off the decoder into windows of ``stack_size`` frames
    every ``step_size`` (the model's own by default); a partial final
    stack is dropped;
  * ``batch_size`` windows run per step, the tail batch padded and
    masked; decode and the copy of batch k+1 run on a producer thread
    while the card runs batch k, and each step is read back ``inflight``
    steps later; ``pack_across_videos`` fills the batches across videos
    (``StackPackingMixin``);
  * the step ships uint8 stacks and transforms them on the device: [0,
    1] → bilinear resize to 128×171 → normalize → center crop 112 →
    R(2+1)D features (B, 512);
  * ``show_pred`` prints each window's Kinetics top-5 from ``fc`` on its
    features.
"""
from __future__ import annotations

from functools import partial
from typing import Dict, Iterable

import numpy as np
import torch

from video_features_torch.cache.key import run_fingerprint
from video_features_torch.config import check_common_keys
from video_features_torch.extract.base import BaseExtractor, StackPackingMixin
from video_features_torch.extract.streaming import (
    iter_batched_windows, stream_windows,
)
from video_features_torch.models import r21d as r21d_model
from video_features_torch.ops.nn import linear
from video_features_torch.ops.precision import features_to_f32
from video_features_torch.ops.transforms import (
    center_crop, normalize, resize_bilinear, to_float_zero_one,
)
from video_features_torch.transplant import float32_params, to_device

# model_name -> (arch, native stack, native step, pred dataset)
MODEL_CFGS = {
    'r2plus1d_18_16_kinetics': dict(arch='r2plus1d_18', stack_size=16,
                                    step_size=16, dataset='kinetics'),
    'r2plus1d_34_32_ig65m_ft_kinetics': dict(arch='r2plus1d_34', stack_size=32,
                                             step_size=32, dataset='kinetics'),
    'r2plus1d_34_8_ig65m_ft_kinetics': dict(arch='r2plus1d_34', stack_size=8,
                                            step_size=8, dataset='kinetics'),
}
STACK_BATCH = 4


def model_def(model_name: str) -> dict:
    """``MODEL_CFGS[model_name]``; an unknown name raises, listing the
    valid ones."""
    try:
        return MODEL_CFGS[model_name]
    except KeyError:
        raise ValueError(f'model_name must be one of {", ".join(MODEL_CFGS)}; '
                         f'got {model_name!r}') from None


def r21d_step(params, stacks: torch.Tensor, arch: str,
              dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, stack, H, W, 3) uint8 → (B, 512) float32 features: [0, 1] in
    ``dtype`` (the lane's activations) → resize to 128×171 → normalize →
    crop 112 → R(2+1)D."""
    x = resize_bilinear(to_float_zero_one(stacks, dtype), (128, 171))
    x = center_crop(normalize(x, r21d_model.MEAN, r21d_model.STD), 112)
    return features_to_f32(r21d_model.forward(params, x, arch=arch,
                                              features=True))


class ExtractR21D(StackPackingMixin, BaseExtractor):

    packed_feat_dim = r21d_model.FEAT_DIM

    def __init__(self, args) -> None:
        super().__init__(args)
        check_common_keys(args)
        self.model_def = model_def(args.get('model_name',
                                            'r2plus1d_18_16_kinetics'))
        self.stack_size = args.get('stack_size') or self.model_def['stack_size']
        self.step_size = args.get('step_size') or self.model_def['step_size']
        self.extraction_fps = args.get('extraction_fps')
        self.batch_size = int(args.get('batch_size') or STACK_BATCH)
        self.show_pred = bool(args.get('show_pred', False))
        self.output_feat_keys = [self.feature_type]
        self.params = to_device(self.load_params(args), self.device)
        self.run_fingerprint = run_fingerprint(args)
        if self.data_parallel:
            self._ensure_mesh('batch_size')

    def load_params(self, args):
        from video_features_torch.extract.weights import load_or_init
        return load_or_init(
            args, 'checkpoint_path',
            partial(r21d_model.init_state_dict, arch=self.model_def['arch']),
            feature_type='r21d', compute_dtype=self.compute_dtype)

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        """Decode (cv2, retimed to ``extraction_fps``), then
        :meth:`extract_frames`."""
        with self.video_loader(video_path, batch_size=64,
                               fps=self.extraction_fps) as loader:
            return self.extract_frames(loader)

    def extract_frames(self, batches: Iterable) -> Dict[str, np.ndarray]:
        """Frame batches ``(frames, times, indices)`` (the loader protocol;
        only ``frames``, a sequence of HWC uint8 frames, is read) →
        ``{'r21d': (T, 512)}``, through the asynchronous loop."""
        feats = []
        windows = stream_windows(self.tracer.wrap_iter('decode', batches),
                                 self.stack_size, self.step_size)
        for out, _, valid, window_idx in self.run_batches(
                iter_batched_windows(windows, self.batch_size),
                depth=1 if self.show_pred else None):
            out = out[self.feature_type][:valid]
            feats.append(out)
            if self.show_pred:
                for k in range(valid):
                    start = (window_idx + k) * self.step_size
                    self.maybe_show_pred(out[k:k + 1], start,
                                         start + self.stack_size)
        return {self.feature_type: (
            np.concatenate(feats, axis=0) if feats
            else np.zeros((0, r21d_model.FEAT_DIM), np.float32))}

    def packed_step(self, stacks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One (batch, stack, H, W, 3) uint8 device batch → {'r21d':
        (batch, 512)}."""
        return {self.feature_type: r21d_step(self.params, stacks,
                                             self.model_def['arch'],
                                             self.act_dtype)}

    def step(self, stacks: np.ndarray) -> np.ndarray:
        """One (batch, stack, H, W, 3) uint8 batch → (batch, 512)."""
        return self.run_step(stacks)[self.feature_type]

    def maybe_show_pred(self, feats: np.ndarray, start: int, end: int) -> None:
        """The window's top-5 from ``fc`` on its features."""
        from video_features_torch.utils.preds import show_predictions_on_dataset
        with torch.inference_mode(), self.precision_scope():
            logits = linear(torch.from_numpy(feats).to(self.device),
                            float32_params(self.params['fc'])).cpu().numpy()
        print(f'At frames ({start}, {end})')
        show_predictions_on_dataset(logits, self.model_def['dataset'])
