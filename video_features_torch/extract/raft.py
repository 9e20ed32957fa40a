"""RAFT flow extractor (port of ``video_features_tpu/extract/raft.py``).

  * consecutive-pair batching: the loader yields ``batch_size + 1``
    frames with overlap 1, so each step computes ``batch_size`` flows;
    a short tail is padded by repeating its last frame and only its
    ``valid`` flows are kept;
  * optional host-side PIL edge resize (``side_size`` /
    ``resize_to_smaller_edge``);
  * replicate pad to ``bucket_multiple`` (``finetuned_on``: 'sintel'
    centers the pad, 'kitti' pads the bottom), flow on the padded frames
    with :func:`models.raft.forward_consecutive`, then unpadded;
  * outputs ``{'raft': (T-1, 2, H, W), 'fps', 'timestamps_ms'}``: the
    flow channels-first, as the reference stores it; the timestamps keep
    every decoded frame (the first batch whole, each later batch minus
    its overlapped head).

The loop decodes (``decode_workers`` resize threads), pads the tail and
copies batch k+1 on a producer thread while the card runs batch k, and
reads each step back ``inflight`` steps later. With ``data_parallel``
the ``batch_size + 1`` frames split into one run of k + 1 frames per
device (k = batch_size / devices; the frame at each shard boundary is
copied into both runs on the host), so each device computes k flows and
encodes each of its frames once, as one device does. RAFT has no packed loop,
in the JAX package either: ``pack_across_videos`` warns and runs this
one.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from video_features_torch.cache.key import run_fingerprint
from video_features_torch.config import check_raft_args
from video_features_torch.extract.base import BaseExtractor
from video_features_torch.models import raft as raft_model
from video_features_torch.transplant import to_device


class ExtractRAFT(BaseExtractor):

    def __init__(self, args) -> None:
        super().__init__(args)
        check_raft_args(args)
        self.batch_size = int(args['batch_size'])
        self.side_size = args.get('side_size')
        self.resize_to_smaller_edge = args.get('resize_to_smaller_edge', True)
        self.extraction_fps = args.get('extraction_fps')
        self.extraction_total = args.get('extraction_total')
        self.finetuned_on = args.get('finetuned_on', 'sintel')
        self.bucket_multiple = int(args.get('bucket_multiple', 8))
        self.show_pred = bool(args.get('show_pred', False))
        self.raft_iters = raft_model.resolve_iters(args.get('raft_iters'))
        self.output_feat_keys = [self.feature_type, 'fps', 'timestamps_ms']
        self.params = to_device(self.load_params(args), self.device)
        self.run_fingerprint = run_fingerprint(args)
        self._viz_stem, self._viz_count = 'frames', 0
        if self.data_parallel:
            self._ensure_mesh('batch_size')
            self._put_batch = self._halo_shards

    def _halo_shards(self, frames: np.ndarray) -> List[np.ndarray]:
        """``(B + 1, ...)`` consecutive frames → one run of ``k + 1`` per
        data shard (k = B / shards): shard d holds frames ``[d·k, d·k +
        k]``, so its k flows are the global flows ``d·k … d·k + k - 1``."""
        n = self._mesh.shape['data']
        k = (len(frames) - 1) // n
        return [frames[d * k: d * k + k + 1] for d in range(n)]

    def load_params(self, args):
        """RAFT params; DataParallel ``module.`` prefixes are stripped by
        the transplant layer."""
        from video_features_torch.extract.weights import load_or_init
        return load_or_init(args, 'checkpoint_path', raft_model.init_state_dict,
                            feature_type='raft')

    def host_transform(self, frame: np.ndarray) -> np.ndarray:
        """uint8 in, uint8 out: RAFT normalizes on the device."""
        if self.side_size is not None:
            from video_features_torch.ops.host_transforms import resize_pil
            frame = resize_pil(frame, self.side_size, self.resize_to_smaller_edge)
        return frame

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        """Decode (cv2) in ``batch_size + 1`` frame batches with overlap 1,
        then :meth:`extract_frames`."""
        self._viz_stem, self._viz_count = Path(video_path).stem, 0
        with self.video_loader(video_path, batch_size=self.batch_size + 1,
                               fps=self.extraction_fps,
                               total=self.extraction_total,
                               transform=self.host_transform,
                               transform_workers=self.decode_workers,
                               overlap=1) as loader:
            return self.extract_frames(loader, loader.fps,
                                       frame_hw=(loader.height, loader.width))

    def extract_frames(self, batches: Iterable, fps: float,
                       frame_hw: Optional[Tuple[int, int]] = None
                       ) -> Dict[str, np.ndarray]:
        """Overlap-1 frame batches ``(frames, times, indices)`` of at most
        ``batch_size + 1`` HWC uint8 frames (``io/video.py::batch_frames``)
        → ``{'raft', 'fps', 'timestamps_ms'}``. ``frame_hw`` is the source
        frame size, for the geometry of an empty video's output."""
        def assembled():
            for k, (frames, times, _) in enumerate(
                    self.tracer.wrap_iter('decode+preprocess', batches)):
                ts = times if k == 0 else times[1:]
                batch = np.stack(frames)
                if batch.shape[0] < 2:
                    yield None, 0, ts        # timestamps only, no pairs
                    continue
                valid = batch.shape[0] - 1
                if valid < self.batch_size:
                    pad = np.repeat(batch[-1:], self.batch_size - valid, axis=0)
                    batch = np.concatenate([batch, pad], axis=0)
                yield batch, valid, ts

        flows, timestamps = [], []
        for out, _, valid, ts in self.run_batches(assembled()):
            timestamps.extend(ts)
            if out is None:
                continue
            flow = out[self.feature_type][:valid]
            flows.append(flow)
            if self.show_pred:
                self.maybe_show_pred(flow)
        if flows:
            features = np.concatenate(flows, axis=0).transpose(0, 3, 1, 2)
        else:
            # the geometry normal outputs would have: after the host resize
            h, w = frame_hw or (0, 0)
            h, w = self.host_transform(np.zeros((h, w, 3), np.uint8)).shape[:2]
            features = np.zeros((0, 2, h, w), np.float32)
        return {self.feature_type: features, 'fps': np.array(fps),
                'timestamps_ms': np.array(timestamps)}

    def packed_step(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B+1, H, W, 3) uint8 consecutive frames on the device → {'raft':
        (B, H, W, 2)} flows: padded to ``bucket_multiple``, then unpadded.
        The step ``dispatch`` runs (RAFT has no packed loop)."""
        padded, pads = raft_model.pad_to_multiple(
            frames, mode=self.finetuned_on, multiple=self.bucket_multiple)
        flow = raft_model.forward_consecutive(self.params, padded,
                                              iters=self.raft_iters,
                                              gru_passes=self.gru_passes)
        return {self.feature_type: raft_model.unpad(flow, pads)}

    def maybe_show_pred(self, flows: np.ndarray) -> None:
        """Render the step's first flow with the Middlebury wheel and write
        it as a PNG under ``<output_path>/flow_debug/`` (the reference
        opens a cv2 window instead). A debug surface: any failure to write
        is a warning event (``flow viz PNG write skipped``), never raised."""
        from video_features_torch.utils.flow_viz import flow_to_image
        img = flow_to_image(flows[0])
        print(f'[flow viz] frame rendered: shape={img.shape}, '
              f'mean_mag={np.linalg.norm(flows[0], axis=-1).mean():.3f}')
        try:
            import cv2
            out_dir = Path(self.output_path) / 'flow_debug'
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f'{self._viz_stem}_{self._viz_count:06d}.png'
            if not cv2.imwrite(str(path), img[..., ::-1]):   # RGB → BGR
                raise OSError(f'cv2.imwrite failed for {path}')
            self._viz_count += 1
        except Exception:
            import logging

            from video_features_torch.obs.events import event
            event(logging.WARNING, 'flow viz PNG write skipped',
                  exc_info=True, subsystem='raft')
