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


def flow_step(params, frames: torch.Tensor, mode: str = 'sintel',
              multiple: int = 8, iters: int = raft_model.ITERS,
              gru_passes: int = 3, three_pass_convs: bool = False
              ) -> torch.Tensor:
    """(B+1, H, W, 3) uint8 consecutive frames → (B, H, W, 2) flows:
    replicate-padded to ``multiple`` (``mode`` 'sintel' centers the pad,
    'kitti' pads the bottom), RAFT on the pairs, then unpadded.
    ``gru_passes`` and ``three_pass_convs`` are the run's ``precision``
    (``models/raft.py``)."""
    padded, pads = raft_model.pad_to_multiple(frames, mode=mode,
                                              multiple=multiple)
    flow = raft_model.forward_consecutive(params, padded, iters=iters,
                                          gru_passes=gru_passes,
                                          three_pass_convs=three_pass_convs)
    return raft_model.unpad(flow, pads)


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

    def kernel_libraries(self) -> tuple:
        """RAFT launches the lookup and GRU kernels on the card, and under
        ``high`` and ``mixed`` the 3xTF32 convolution."""
        if self.device.type != 'cuda':
            return ()
        return raft_model.KERNEL_LIBRARIES + (
            (raft_model.CONV_LIBRARY,) if self.three_pass_convs else ())

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

    def _step_kwargs(self) -> dict:
        return dict(mode=self.finetuned_on, multiple=self.bucket_multiple,
                    iters=self.raft_iters, gru_passes=self.gru_passes,
                    three_pass_convs=self.three_pass_convs)

    def packed_step(self, frames: torch.Tensor) -> Dict[str, torch.Tensor]:
        """(B+1, H, W, 3) uint8 consecutive frames on the device → {'raft':
        (B, H, W, 2)} flows (:func:`flow_step`). The step ``dispatch``
        runs (RAFT has no packed loop)."""
        return {self.feature_type: flow_step(self.params, frames,
                                             **self._step_kwargs())}

    def program_specs(self, mesh=None):
        """The consecutive-pair flow step over ``batch_size + 1`` frames
        at the canonical decode geometry (already /8-aligned); on a mesh
        ``flow_step_dp``: each device's run of k + 1 frames (the shard
        boundary frame copied into both runs, :meth:`_halo_shards`), k =
        ``batch_size`` flows per device."""
        h, w = self.PROGRAM_DECODE_HW
        k = max(int(self.batch_size), 1)
        if mesh is None:
            return [self._program_spec('flow_step', flow_step,
                                       (k + 1, h, w, 3), torch.uint8,
                                       kwargs=self._step_kwargs())]
        n = mesh.shape['data']
        return [self._program_spec('flow_step_dp', flow_step,
                                   (n * (k + 1), h, w, 3), torch.uint8,
                                   mesh, kwargs=self._step_kwargs())]

    def maybe_show_pred(self, flows: np.ndarray) -> None:
        """Render the step's first flow with the Middlebury wheel and write
        it as a PNG under ``<output_path>/flow_debug/`` (the reference
        opens a cv2 window instead). A debug surface: any failure to write
        is a warning event (``flow viz PNG write skipped``), never raised."""
        from video_features_torch.utils.flow_viz import flow_to_image
        img = flow_to_image(flows[0])
        # vft-lint: ok=stdout-purity — show_pred narration surface
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
