"""S3D extractor (port of ``video_features_tpu/extract/s3d.py``).

  * windows of ``stack_size`` frames every ``step_size`` (64 and 64 at
    25 fps by default), ``batch_size`` (1) windows per step, the tail
    batch padded and masked; a partial final stack is dropped; the loop
    is asynchronous and packs across videos as r21d's does;
  * the step ships uint8 stacks and transforms them on the device, with
    no normalization (the kylemin/S3D convention): [0, 1] → short-side
    224 bilinear resize at the GIVEN scale 224/min(h, w) → center crop
    224 → S3D features (B, 1024);
  * ``show_pred`` recomputes each window with the classifier head and
    prints its Kinetics top-5.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, Tuple

import numpy as np
import torch

from video_features_torch.cache.key import run_fingerprint
from video_features_torch.config import check_unported_keys
from video_features_torch.extract.base import BaseExtractor, StackPackingMixin
from video_features_torch.extract.streaming import (
    iter_batched_windows, stream_windows,
)
from video_features_torch.models import s3d as s3d_model
from video_features_torch.ops.precision import features_to_f32
from video_features_torch.ops.transforms import (
    center_crop, resize_bilinear_scale, to_float_zero_one,
)
from video_features_torch.transplant import to_device

SIZE = 224
STACK_BATCH = 1


def resize_geometry(h: int, w: int) -> Tuple[Tuple[int, int], float]:
    """((oh, ow), scale) of the short-side resize: ``scale = 224/min(h,
    w)`` and ``floor(dim·scale)`` per side, as torch's ``F.interpolate(
    scale_factor=scale, recompute_scale_factor=False)`` sizes it (a
    107-px short side floors to 223)."""
    scale = SIZE / min(h, w)
    return (math.floor(h * scale), math.floor(w * scale)), scale


def s3d_step(params, stacks: torch.Tensor, features: bool = True,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """(B, stack, H, W, 3) uint8 → (B, 1024) float32 features (or (B,
    400) logits): [0, 1] in ``dtype`` (the lane's activations) → resize
    at the given scale (in ``dtype``) → crop 224 → S3D."""
    size, scale = resize_geometry(*stacks.shape[2:4])
    x = resize_bilinear_scale(to_float_zero_one(stacks, dtype), size, scale)
    return features_to_f32(s3d_model.forward(params, center_crop(x, SIZE),
                                             features=features))


class ExtractS3D(StackPackingMixin, BaseExtractor):

    packed_feat_dim = s3d_model.FEAT_DIM

    def __init__(self, args) -> None:
        super().__init__(args)
        check_unported_keys(args)
        self.stack_size = int(args.get('stack_size') or 64)
        self.step_size = int(args.get('step_size') or 64)
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
        return load_or_init(args, 'checkpoint_path', s3d_model.init_state_dict,
                            feature_type='s3d', compute_dtype=self.compute_dtype)

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        """Decode (cv2, retimed to ``extraction_fps``), then
        :meth:`extract_frames`."""
        with self.video_loader(video_path, batch_size=64,
                               fps=self.extraction_fps) as loader:
            return self.extract_frames(loader)

    def extract_frames(self, batches: Iterable) -> Dict[str, np.ndarray]:
        """Frame batches ``(frames, times, indices)`` (the loader protocol;
        only ``frames``, a sequence of HWC uint8 frames, is read) →
        ``{'s3d': (T, 1024)}``, through the asynchronous loop."""
        feats = []
        windows = stream_windows(self.tracer.wrap_iter('decode', batches),
                                 self.stack_size, self.step_size)
        for out, stacks, valid, window_idx in self.run_batches(
                iter_batched_windows(windows, self.batch_size),
                keep_host=self.show_pred,
                depth=1 if self.show_pred else None):
            feats.append(out[self.feature_type][:valid])
            if self.show_pred:
                for k in range(valid):
                    start = (window_idx + k) * self.step_size
                    self.maybe_show_pred(stacks[k:k + 1], start,
                                         start + self.stack_size)
        return {self.feature_type: (
            np.concatenate(feats, axis=0) if feats
            else np.zeros((0, s3d_model.FEAT_DIM), np.float32))}

    def packed_step(self, stacks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One (batch, stack, H, W, 3) uint8 device batch → {'s3d':
        (batch, 1024)}."""
        return {self.feature_type: s3d_step(self.params, stacks,
                                            dtype=self.act_dtype)}

    def step(self, stacks: np.ndarray, features: bool = True) -> np.ndarray:
        """One (batch, stack, H, W, 3) uint8 batch → (batch, 1024), or
        (batch, 400) logits."""
        if features:
            return self.run_step(stacks)[self.feature_type]
        x = torch.from_numpy(stacks).to(self.device)
        with torch.inference_mode(), self.precision_scope():
            return s3d_step(self.params, x, features=False,
                            dtype=self.act_dtype).cpu().numpy()

    def maybe_show_pred(self, stacks: np.ndarray, start: int, end: int) -> None:
        """The window's top-5, recomputed through the classifier head."""
        from video_features_torch.utils.preds import show_predictions_on_dataset
        logits = self.step(stacks, features=False)
        print(f'At frames ({start}, {end})')
        show_predictions_on_dataset(logits, 'kinetics')
