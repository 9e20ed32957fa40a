"""I3D two-stream extractor — the fused RAFT→I3D path (port of
``video_features_tpu/extract/i3d.py``).

  * frames are resized to short side 256 and windowed into stacks of
    ``stack_size + 1`` frames: S+1 frames give S flow pairs, and the rgb
    stream takes the first S frames so both streams have the same
    length. The resize runs on the host (PIL), or with
    ``device_resize=true`` on the device inside the step, bit-exact with
    PIL (``ops/transforms.py::pil_resize_bilinear_device``), so the
    decode-geometry frames ship as they are;
  * flow stream: RAFT on /8 edge-padded consecutive pairs; the center
    crop is taken from the PADDED flow, as the reference does; then
    clamp ±20 → uint8 levels → ±1;
  * rgb stream: crop 224 → 2x/255 - 1;
  * ``step_size`` < ``stack_size`` overlaps windows; a partial final
    stack is dropped; ``batch_size`` windows run per step, the tail
    batch padded and masked;
  * the per-video loop decodes (``decode_workers`` resize threads) and
    copies batch k+1 on a producer thread while the card runs batch k,
    and reads each step back ``inflight`` steps later (1 under
    ``show_pred``); the packed loop (``pack_across_videos``) runs the
    same step on batches filled across videos, grouped by geometry;
  * ``show_pred`` prints each stream's Kinetics top-5 per window batch
    and writes the first pair's flow as a PNG under
    ``<output_path>/flow_debug/``.
"""
from __future__ import annotations

import sys
from functools import partial
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from video_features_torch.cache.key import run_fingerprint
from video_features_torch.config import check_common_keys
from video_features_torch.extract.base import BaseExtractor
from video_features_torch.extract.streaming import (
    iter_batched_windows, segment_frame_range, stream_windows,
)
from video_features_torch.farm.recipes import resolve_transform
from video_features_torch.models import i3d as i3d_model
from video_features_torch.models import raft as raft_model
from video_features_torch.ops.host_transforms import pil_edge_resize_geometry
from video_features_torch.ops.transforms import (
    center_crop, flow_to_uint8_levels, pil_resize_bilinear_device,
    scale_to_pm1,
)
from video_features_torch.transplant import to_device

MIN_SIDE_SIZE = 256
CROP_SIZE = 224


def rgb_stream_input(stacks: torch.Tensor, crop_size: int) -> torch.Tensor:
    """(B, S+1, H, W, 3) frames → rgb I3D input: first S frames, center
    crop, 2x/255 - 1."""
    return scale_to_pm1(center_crop(stacks[:, :-1], crop_size))


def flow_stream_input(raft_params, stacks: torch.Tensor, pads, crop_size: int,
                      raft_iters: int = raft_model.ITERS,
                      plain_kernels: bool = False,
                      gru_passes: int = 3) -> torch.Tensor:
    """(B, S+1, H, W, 3) frames → quantized flow I3D input (B, S, c, c, 2)."""
    padded = raft_model.edge_pad(stacks, pads, h_axis=2)
    flow = raft_model.forward_stack_pairs(raft_params, padded,
                                          iters=raft_iters,
                                          plain_kernels=plain_kernels,
                                          gru_passes=gru_passes)
    flow = center_crop(flow, crop_size)
    return scale_to_pm1(flow_to_uint8_levels(flow, 20.0))


def fused_two_stream_step(params, stacks: torch.Tensor, pads,
                          streams: Sequence[str], crop_size: int = CROP_SIZE,
                          raft_iters: int = raft_model.ITERS,
                          plain_kernels: bool = False,
                          resize_to: Optional[Tuple[int, int]] = None,
                          gru_passes: int = 3) -> Dict[str, torch.Tensor]:
    """(B, stack+1, H, W, 3) frames → {stream: (B, 1024)}: RAFT flow,
    quantization and both I3D towers. ``resize_to=(H', W')`` first
    resizes the uint8 frames on the device (``device_resize``; ``pads``
    are then those of H'×W'). ``plain_kernels`` runs RAFT's lookup and
    GRU direction through their plain versions instead of the kernels (a
    test seam); ``gru_passes`` is the GRU kernel's TF32 products per fp32
    product (the run's ``precision``)."""
    if resize_to is not None:
        stacks = pil_resize_bilinear_device(stacks, resize_to)
    out = {}
    if 'rgb' in streams:
        out['rgb'] = i3d_model.forward(params['rgb'],
                                       rgb_stream_input(stacks, crop_size))
    if 'flow' in streams:
        flow = flow_stream_input(params['raft'], stacks, pads, crop_size,
                                 raft_iters=raft_iters,
                                 plain_kernels=plain_kernels,
                                 gru_passes=gru_passes)
        out['flow'] = i3d_model.forward(params['flow'], flow)
    return out


class ExtractI3D(BaseExtractor):

    supports_packing = True

    def __init__(self, args) -> None:
        super().__init__(args)
        streams = args.get('streams')
        self.streams: List[str] = ['rgb', 'flow'] if streams is None else [streams]
        for s in self.streams:
            if s not in ('rgb', 'flow'):
                raise ValueError(f"unknown stream {s!r}: use 'rgb' or 'flow'")
        if args.get('flow_type', 'raft') != 'raft':
            raise NotImplementedError('only flow_type=raft is supported')
        check_common_keys(args)
        stack, step = args.get('stack_size'), args.get('step_size')
        self.stack_size = 64 if stack is None else int(stack)
        self.step_size = 64 if step is None else int(step)
        self.raft_iters = raft_model.resolve_iters(args.get('raft_iters'))
        self.extraction_fps = args.get('extraction_fps')
        self.batch_size = int(args.get('batch_size', 1))
        self.device_resize = bool(args.get('device_resize', False))
        self.show_pred = bool(args.get('show_pred', False))
        self.output_feat_keys = list(self.streams)
        self.params = to_device(self.load_params(args), self.device)
        self.run_fingerprint = run_fingerprint(args)
        self._viz_stem = 'frames'
        self._geometries: Dict[Tuple[int, int], tuple] = {}
        if self.data_parallel:
            self._ensure_mesh('batch_size')

    def load_params(self, args):
        """{'rgb': i3d params, 'flow': i3d params, 'raft': raft params}."""
        from video_features_torch.extract.weights import load_or_init
        params = {}
        if 'rgb' in self.streams:
            params['rgb'] = load_or_init(
                args, 'i3d_rgb_checkpoint_path',
                partial(i3d_model.init_state_dict, modality='rgb'),
                feature_type='i3d', what='i3d rgb stream')
        if 'flow' in self.streams:
            params['flow'] = load_or_init(
                args, 'i3d_flow_checkpoint_path',
                partial(i3d_model.init_state_dict, modality='flow'),
                feature_type='i3d', what='i3d flow stream')
            params['raft'] = load_or_init(
                args, 'raft_checkpoint_path', raft_model.init_state_dict,
                feature_type='i3d', what='i3d flow stream (raft)')
        return params

    def kernel_libraries(self) -> tuple:
        """The flow stream's RAFT launches the lookup and GRU kernels on
        the card."""
        return (raft_model.KERNEL_LIBRARIES if 'flow' in self.streams
                and self.device.type == 'cuda' else ())

    def host_transform_spec(self):
        """Short side to 256 on the host (PIL bilinear), unless
        ``device_resize`` (None: raw frames ship)."""
        return (None if self.device_resize
                else ('edge_resize', MIN_SIDE_SIZE, 'bilinear'))

    def warm_window(self) -> np.ndarray:
        h, w = self.WARM_FRAME_HW
        if not self.device_resize:
            h, w = pil_edge_resize_geometry(h, w, MIN_SIDE_SIZE) or (h, w)
        return np.zeros((self.stack_size + 1, h, w, 3), np.uint8)

    def _loader(self, video_path: str):
        """The video's loader, its frames through
        :meth:`host_transform_spec` over ``decode_workers`` threads."""
        return self.video_loader(
            video_path, batch_size=64, fps=self.extraction_fps,
            transform=resolve_transform(self.host_transform_spec()),
            transform_workers=self.decode_workers)

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        """Decode (cv2), resize to short side 256 on the host (PIL) unless
        ``device_resize``, then :meth:`extract_frames`."""
        self._viz_stem = Path(video_path).stem
        with self._loader(video_path) as loader:
            return self.extract_frames(loader)

    def extract_frames(self, batches: Iterable) -> Dict[str, np.ndarray]:
        """Frame batches ``(frames, times, indices)`` (the loader protocol;
        only ``frames``, a sequence of HWC uint8 frames, is read) →
        ``{stream: (T, 1024)}``, through the asynchronous loop
        (:meth:`~video_features_torch.extract.base.BaseExtractor.run_batches`)."""
        feats: Dict[str, list] = {s: [] for s in self.streams}
        windows = stream_windows(self.tracer.wrap_iter('decode+preprocess', batches),
                                 self.stack_size + 1, self.step_size)
        for out, stacks, valid, window_idx in self.run_batches(
                iter_batched_windows(windows, self.batch_size),
                keep_host=self.show_pred,
                depth=1 if self.show_pred else None):
            for s in self.streams:
                feats[s].append(out[s][:valid])
            if self.show_pred:
                self.maybe_show_pred(stacks[:valid], window_idx)
        return {s: (np.concatenate(v, axis=0) if v
                    else np.zeros((0, i3d_model.FEAT_DIM), np.float32))
                for s, v in feats.items()}

    def geometry(self, h: int, w: int):
        """(resize_to, pads) of (h, w) frames, cached per geometry for
        both loops: the device resize's target (None when the host
        resized them, or when PIL's resize is a no-op) and RAFT's /8 pads
        of the frames it then sees."""
        geom = self._geometries.get((h, w))
        if geom is None:
            resize_to = (pil_edge_resize_geometry(h, w, MIN_SIDE_SIZE)
                         if self.device_resize else None)
            geom = self._geometries[(h, w)] = (
                resize_to, raft_model.pad_amounts(*(resize_to or (h, w))))
        return geom

    def packed_step(self, stacks: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One (batch, S+1, H, W, 3) uint8 device batch → {stream:
        (batch, 1024)} device tensors."""
        resize_to, pads = self.geometry(*stacks.shape[2:4])
        return fused_two_stream_step(self.params, stacks, pads, self.streams,
                                     raft_iters=self.raft_iters,
                                     resize_to=resize_to,
                                     gru_passes=self.gru_passes)

    def step(self, stacks: np.ndarray) -> Dict[str, np.ndarray]:
        """One (batch, S+1, H, W, 3) uint8 stack batch → {stream: (batch,
        1024)}, synchronously (``tools/profile_torch_i3d.py``)."""
        return self.run_step(stacks)

    def packed_windows(self, task):
        with self._loader(task.path) as loader:
            for window in stream_windows(
                    loader, self.stack_size + 1, self.step_size,
                    frame_range=segment_frame_range(task.segment,
                                                    loader.fps)):
                yield window, None

    def live_window_spec(self):
        """Stacks of ``stack_size + 1`` raw frames (S flow pairs) stepped
        by ``step_size``, each frame through the host short-side resize
        unless ``device_resize`` moved it into the step."""
        return (self.stack_size + 1, self.step_size,
                resolve_transform(self.host_transform_spec()), False)

    def farm_recipe(self):
        """Stacks of ``stack_size + 1`` frames through
        :meth:`host_transform_spec`."""
        from video_features_torch.farm.recipes import StackRecipe
        return StackRecipe(
            win=self.stack_size + 1, step=self.step_size, batch_size=64,
            fps=self.extraction_fps, total=None, tmp_path=self.tmp_path,
            keep_tmp=self.keep_tmp_files, backend=self.decode_backend,
            transform=self.host_transform_spec())

    def packed_result(self, task) -> Dict[str, np.ndarray]:
        return {s: (np.stack(task.rows[s]) if task.rows.get(s)
                    else np.zeros((0, i3d_model.FEAT_DIM), np.float32))
                for s in self.streams}

    def maybe_show_pred(self, stacks: np.ndarray, stack_counter: int) -> None:
        """Kinetics top-5 per stream for a batch of windows, recomputed
        through each tower's classifier head (RAFT at this run's
        ``raft_iters``), and, with the flow stream, the first pair's
        cropped flow rendered with the Middlebury wheel as
        ``<output_path>/flow_debug/<stem>_stack_<k>.png``. A debug
        surface: a failed PNG write is reported, never raised."""
        from video_features_torch.utils.flow_viz import flow_to_image
        from video_features_torch.utils.preds import show_predictions_on_dataset
        resize_to, pads = self.geometry(*stacks.shape[2:4])
        x = torch.from_numpy(stacks).to(self.device)
        with torch.inference_mode(), self.precision_scope():
            if resize_to is not None:
                x = pil_resize_bilinear_device(x, resize_to)
            crop = min(CROP_SIZE, x.shape[2], x.shape[3])
            for stream in self.streams:
                if stream == 'rgb':
                    inp = rgb_stream_input(x, crop)
                else:
                    inp = flow_stream_input(self.params['raft'], x, pads, crop,
                                            raft_iters=self.raft_iters,
                                            gru_passes=self.gru_passes)
                _, logits = i3d_model.forward(self.params[stream], inp,
                                              features=False)
                print(f'At stack {stack_counter} ({stream} stream)')
                show_predictions_on_dataset(logits.cpu().numpy(), 'kinetics')
            if 'flow' not in self.streams:
                return
            pair = raft_model.edge_pad(x[:1, :2], pads, h_axis=2)
            flow = raft_model.forward_stack_pairs(self.params['raft'], pair,
                                                  iters=self.raft_iters,
                                                  gru_passes=self.gru_passes)
            flow = center_crop(flow, crop)[0, 0].cpu().numpy()
        img = flow_to_image(flow)
        try:
            import cv2
            out_dir = Path(self.output_path) / 'flow_debug'
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f'{self._viz_stem}_stack_{stack_counter:06d}.png'
            if not cv2.imwrite(str(path), img[..., ::-1]):   # RGB → BGR
                raise OSError(f'cv2.imwrite failed for {path}')
        except (ImportError, OSError) as e:
            print(f'WARNING: flow viz PNG not written ({e})', file=sys.stderr)
