"""Picklable decode recipes: what a farm worker runs for one video (the
port's copy of ``video_features_tpu/farm/recipes.py``).

A recipe describes a family's decode and host transform in a form a
worker process can replay byte for byte without the extractor, whose
weights stay on the card in the parent. ``recipe.open(path, segment=)``
returns ``(info, windows)``: ``info`` is the video-level metadata folded
into ``task.info`` (the frame-wise ``fps``), and ``windows`` yields
``(window, meta)`` as the family's ``packed_windows`` does, a segment's
range filter and early stop included.

Transforms are named specs (``('edge_resize', size, interp)``,
``('edge_resize_crop', resize, crop, interp)``) over
``ops/host_transforms.py``, so a worker imports numpy, cv2 and PIL and
never torch. A family whose transform has no spec returns None from
``farm_recipe()`` and the packed loop decodes in-process.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np

TransformSpec = Tuple


def resolve_transform(spec: Optional[TransformSpec]
                      ) -> Optional[Callable[[np.ndarray], np.ndarray]]:
    """A transform spec as a per-frame callable (None for None)."""
    if spec is None:
        return None
    from video_features_torch.ops.host_transforms import (
        center_crop_host, resize_pil,
    )
    kind = spec[0]
    if kind == 'edge_resize':
        _, size, interp = spec
        return lambda f: resize_pil(f, size, interpolation=interp)
    if kind == 'edge_resize_crop':
        _, resize, crop, interp = spec
        return lambda f: center_crop_host(
            resize_pil(f, resize, interpolation=interp), crop)
    raise ValueError(f'unknown transform spec {spec!r}')


class _LoaderRecipe:
    """The loader every recipe builds: the in-process path's
    ``io.video.VideoLoader`` with the same retiming, ``decode_backend``,
    ``tmp_path`` and ``keep_tmp_files``; the recipes close it however
    iteration ends."""

    def __init__(self, batch_size: int, fps, total, tmp_path: str,
                 keep_tmp: bool, backend: str,
                 transform: Optional[TransformSpec]) -> None:
        self.batch_size = int(batch_size)
        self.fps = fps
        self.total = total
        self.tmp_path = str(tmp_path)
        self.keep_tmp = bool(keep_tmp)
        self.backend = backend
        self.transform = transform

    def _make_loader(self, path: str):
        from video_features_torch.io.video import VideoLoader
        return VideoLoader(path, batch_size=self.batch_size, fps=self.fps,
                           total=self.total, tmp_path=self.tmp_path,
                           keep_tmp=self.keep_tmp,
                           transform=resolve_transform(self.transform),
                           backend=self.backend)


class FramewiseRecipe(_LoaderRecipe):
    """One window is one host-transformed frame, its meta the frame's
    timestamp: the frame-wise families' ``packed_windows``."""

    def open(self, path: str, segment=None) -> Tuple[Dict, Iterator]:
        from video_features_torch.extract.streaming import (
            framewise_segment_windows, segment_frame_range,
        )
        loader = self._make_loader(path)
        frame_range = segment_frame_range(segment, loader.fps)

        def windows():
            try:
                yield from framewise_segment_windows(loader, frame_range)
            finally:
                loader.close()

        return {'fps': loader.fps}, windows()


class FusedRecipe(_LoaderRecipe):
    """One raw decode per video, branched into every family's transform.

    The loader decodes raw frames, and each frame goes through every
    family's spec in the order given, which is byte-equal to one decode
    per family: the in-process loader applies its transform as a pure
    per-frame call on the same decoded bytes. Each window's meta is
    ``(family, t_ms)``, so the packer routes it to that family's pools.
    ``select`` (a subset of the families) drops the families that no
    longer want this video (resume skips, failures) from the fan-out.
    """

    def __init__(self, batch_size: int, fps, total, tmp_path: str,
                 keep_tmp: bool, backend: str,
                 transforms: Dict[str, Optional[TransformSpec]]) -> None:
        super().__init__(batch_size, fps, total, tmp_path, keep_tmp,
                         backend, transform=None)
        self.transforms = dict(transforms)     # family → spec, in order

    def family_of(self, meta) -> Optional[str]:
        """The family a window's meta names (its decode span's
        ``family`` arg), or None."""
        if isinstance(meta, tuple) and len(meta) == 2:
            return meta[0]
        return None

    def open(self, path: str, segment=None,
             select=None) -> Tuple[Dict, Iterator]:
        from video_features_torch.extract.streaming import (
            framewise_segment_windows, segment_frame_range,
        )
        loader = self._make_loader(path)
        frame_range = segment_frame_range(segment, loader.fps)
        branch = {f: resolve_transform(spec)
                  for f, spec in self.transforms.items()
                  if select is None or f in select}

        def windows():
            try:
                for frame, t_ms in framewise_segment_windows(loader,
                                                             frame_range):
                    for fam, t in branch.items():
                        yield (frame if t is None else t(frame)), (fam, t_ms)
            finally:
                loader.close()

        return {'fps': loader.fps}, windows()


class StackRecipe(_LoaderRecipe):
    """One window is a ``(win, H, W, 3)`` frame stack, stepped by
    ``step``: the stack families' ``packed_windows`` (r21d and s3d: raw
    frames, ``win = stack_size``; i3d: ``win = stack_size + 1``, and the
    host short-side resize unless ``device_resize``)."""

    def __init__(self, win: int, step: int, batch_size: int, fps, total,
                 tmp_path: str, keep_tmp: bool, backend: str,
                 transform: Optional[TransformSpec]) -> None:
        super().__init__(batch_size, fps, total, tmp_path, keep_tmp,
                         backend, transform)
        self.win = int(win)
        self.step = int(step)

    def open(self, path: str, segment=None) -> Tuple[Dict, Iterator]:
        from video_features_torch.extract.streaming import (
            segment_frame_range, stream_windows,
        )
        loader = self._make_loader(path)
        frame_range = segment_frame_range(segment, loader.fps)

        def windows():
            try:
                for window in stream_windows(loader, self.win, self.step,
                                             frame_range=frame_range):
                    yield window, None
            finally:
                loader.close()

        return {}, windows()
