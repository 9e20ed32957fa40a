"""Frame-wise extractor base for the image backbones (ResNet, CLIP), port
of ``video_features_tpu/extract/framewise.py``.

  * decode (cv2, retimed to ``extraction_fps`` or ``extraction_total``)
    → the family's per-frame host transform (PIL edge resize and center
    crop, uint8 in and out) → batches of ``batch_size`` frames → the
    family's step on the device (float conversion, normalization, the
    backbone) → one row per frame;
  * outputs ``{feature_type: (T, D) float32, 'fps', 'timestamps_ms'}``,
    with ``(0, D)`` for a video with no frames;
  * the tail batch runs at its own size: nothing is compiled for a
    batch shape, and each row depends on its own frame only.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from video_features_torch.config import check_unported_keys
from video_features_torch.extract.base import (
    FINGERPRINT_KEYS, BaseExtractor, run_fingerprint,
)


class BaseFrameWiseExtractor(BaseExtractor):

    def __init__(self, args, feat_dim: int) -> None:
        super().__init__(args)
        check_unported_keys(args)
        self.batch_size = int(args.get('batch_size') or 1)
        self.extraction_fps = args.get('extraction_fps')
        self.extraction_total = args.get('extraction_total')
        self.show_pred = bool(args.get('show_pred', False))
        self.feat_dim = feat_dim
        self.output_feat_keys = [self.feature_type, 'fps', 'timestamps_ms']
        self.run_fingerprint = run_fingerprint(args,
                                               FINGERPRINT_KEYS[self.feature_type])

    # subclasses provide:
    def host_transform(self, frame: np.ndarray) -> np.ndarray:
        """HWC uint8 RGB frame → fixed-size HWC uint8 (resize + crop)."""
        raise NotImplementedError

    def device_step(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device → (B, D) float32 features."""
        raise NotImplementedError

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        pass

    def step(self, frames: np.ndarray) -> np.ndarray:
        """(B, H, W, 3) host-transformed uint8 frames → (B, D) features."""
        x = torch.from_numpy(frames).to(self.device)
        with torch.inference_mode():
            return self.device_step(x).cpu().numpy()

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        """Decode in ``batch_size`` batches through :meth:`host_transform`,
        then :meth:`extract_frames`."""
        with self.video_loader(video_path, batch_size=self.batch_size,
                               fps=self.extraction_fps,
                               total=self.extraction_total,
                               transform=self.host_transform) as loader:
            return self.extract_frames(loader, loader.fps)

    def extract_frames(self, batches: Iterable, fps: float
                       ) -> Dict[str, np.ndarray]:
        """Batches ``(frames, times_ms, indices)`` of host-transformed
        uint8 frames (the loader protocol) → ``{feature_type: (T, D),
        'fps', 'timestamps_ms'}``; each batch is one step."""
        feats, timestamps = [], []
        for frames, times, _ in batches:
            out = self.step(np.stack(frames))
            feats.append(out)
            timestamps.extend(times)
            if self.show_pred:
                self.maybe_show_pred(out)
        features = (np.concatenate(feats, axis=0) if feats
                    else np.zeros((0, self.feat_dim), np.float32))
        return {self.feature_type: features, 'fps': np.array(fps),
                'timestamps_ms': np.array(timestamps)}
