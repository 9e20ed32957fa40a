"""Frame-wise extractor base for the image backbones (ResNet, CLIP), port
of ``video_features_tpu/extract/framewise.py``.

  * decode (cv2, retimed to ``extraction_fps`` or ``extraction_total``)
    → the family's per-frame host transform (PIL edge resize and center
    crop, uint8 in and out) → batches of ``batch_size`` frames → the
    family's step on the device (float conversion, normalization, the
    backbone) → one row per frame;
  * outputs ``{feature_type: (T, D) float32, 'fps', 'timestamps_ms'}``,
    with ``(0, D)`` for a video with no frames;
  * the tail batch is padded to ``batch_size`` by repeating its last
    frame, as in the JAX package, so the per-video and the packed loop
    run the same step shapes and give the same bytes;
  * the per-video loop decodes and transforms (over ``decode_workers``
    threads) and copies batch k+1 on a producer thread while the card
    runs batch k, and reads each step back ``inflight`` steps later;
  * the packed loop (``pack_across_videos``) packs single frames across
    videos: a window's meta is its timestamp, ``fps`` rides in
    ``task.info``, and a segment query keeps the frames of its range; the family's host transform is a named spec
    (``host_transform_spec``), which the decode farm's workers and the
    fused worklists (one decode, several families) replay.
"""
from __future__ import annotations

from typing import Dict, Iterable

import numpy as np
import torch

from video_features_torch.cache.key import run_fingerprint
from video_features_torch.config import check_common_keys
from video_features_torch.extract.base import BaseExtractor
from video_features_torch.extract.streaming import (
    framewise_segment_windows, segment_frame_range,
)
from video_features_torch.farm.recipes import resolve_transform


class BaseFrameWiseExtractor(BaseExtractor):

    supports_packing = True

    def __init__(self, args, feat_dim: int) -> None:
        super().__init__(args)
        check_common_keys(args)
        self.batch_size = int(args.get('batch_size') or 1)
        self.extraction_fps = args.get('extraction_fps')
        self.extraction_total = args.get('extraction_total')
        self.show_pred = bool(args.get('show_pred', False))
        self.feat_dim = feat_dim
        self.output_feat_keys = [self.feature_type, 'fps', 'timestamps_ms']
        self.run_fingerprint = run_fingerprint(args)

    # subclasses provide:
    def host_transform_spec(self):
        """The per-frame host transform as a named spec of
        ``farm/recipes.py`` (``('edge_resize_crop', resize, crop,
        interpolation)``): the in-process loaders, the decode farm's
        workers and fused worklists all run it."""
        raise NotImplementedError

    def device_step(self, frames: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) uint8 on the device → (B, D) float32 features."""
        raise NotImplementedError

    def maybe_show_pred(self, feats: np.ndarray) -> None:
        pass

    def host_transform(self, frame: np.ndarray) -> np.ndarray:
        """HWC uint8 RGB frame → fixed-size HWC uint8 (resize + crop)."""
        return resolve_transform(self.host_transform_spec())(frame)

    def warm_window(self) -> np.ndarray:
        return self.host_transform(np.zeros((*self.WARM_FRAME_HW, 3), np.uint8))

    def packed_step(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        return {self.feature_type: self.device_step(frames)}

    def _loader(self, video_path: str):
        return self.video_loader(video_path, batch_size=self.batch_size,
                                 fps=self.extraction_fps,
                                 total=self.extraction_total,
                                 transform=resolve_transform(
                                     self.host_transform_spec()),
                                 transform_workers=self.decode_workers)

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        """Decode in ``batch_size`` batches through :meth:`host_transform`,
        then :meth:`extract_frames`."""
        with self._loader(video_path) as loader:
            return self.extract_frames(loader, loader.fps)

    def extract_frames(self, batches: Iterable, fps: float
                       ) -> Dict[str, np.ndarray]:
        """Batches ``(frames, times_ms, indices)`` of host-transformed
        uint8 frames (the loader protocol) → ``{feature_type: (T, D),
        'fps', 'timestamps_ms'}``; each batch is one step, a short one
        padded to ``batch_size``."""
        def assembled():
            for frames, times, _ in self.tracer.wrap_iter('decode+preprocess',
                                                          batches):
                batch = np.stack(frames)
                valid = len(batch)
                if valid < self.batch_size:
                    pad = np.repeat(batch[-1:], self.batch_size - valid, axis=0)
                    batch = np.concatenate([batch, pad], axis=0)
                yield batch, valid, times

        feats, timestamps = [], []
        for out, _, valid, times in self.run_batches(
                assembled(), depth=1 if self.show_pred else None):
            out = out[self.feature_type][:valid]
            feats.append(out)
            timestamps.extend(times)
            if self.show_pred:
                self.maybe_show_pred(out)
        features = (np.concatenate(feats, axis=0) if feats
                    else np.zeros((0, self.feat_dim), np.float32))
        return {self.feature_type: features, 'fps': np.array(fps),
                'timestamps_ms': np.array(timestamps)}

    def packed_windows(self, task):
        with self._loader(task.path) as loader:
            task.info['fps'] = loader.fps
            yield from framewise_segment_windows(
                loader, segment_frame_range(task.segment, loader.fps))

    def live_window_spec(self):
        # a window is one host-transformed frame; the live session stamps
        # its timestamp from the session's declared fps
        return (1, 1, self.host_transform, True)

    def farm_recipe(self):
        from video_features_torch.farm.recipes import FramewiseRecipe
        return FramewiseRecipe(
            batch_size=self.batch_size, fps=self.extraction_fps,
            total=self.extraction_total, tmp_path=self.tmp_path,
            keep_tmp=self.keep_tmp_files, backend=self.decode_backend,
            transform=self.host_transform_spec())

    def fused_decode_signature(self):
        """Frame-wise families share a raw frame stream when the retiming
        and the decoder match: the host transform is a pure per-frame
        call on the decoded frame (``io.video.VideoLoader``)."""
        return ('framewise', self.extraction_fps, self.extraction_total,
                self.decode_backend)

    def packed_result(self, task) -> Dict[str, np.ndarray]:
        rows = task.rows.get(self.feature_type, [])
        return {self.feature_type: (np.stack(rows) if rows
                                    else np.zeros((0, self.feat_dim), np.float32)),
                'fps': np.array(task.info.get('fps', 0.0)),
                'timestamps_ms': np.array(task.meta_rows)}
