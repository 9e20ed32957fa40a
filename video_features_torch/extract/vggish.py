"""VGGish audio extractor, port of ``video_features_tpu/extract/vggish.py``.

A ``.wav`` is read directly; an ``.mp4``'s audio comes through
``audio_backend``: ``ffmpeg`` (the reference's mp4 → aac → wav chain,
temp files removed unless ``keep_tmp_files``), ``native`` (in-process
libav straight to mono 16 kHz, ``io/native.py``), or ``auto`` (ffmpeg
when the binary is there, else native when the library loads, else an
error naming both). Any other extension raises.

The log-mel DSP runs on the host in float64 (``ops/audio.py``) and
narrows to float32 just before the copy to the device; the 0.96 s
examples go through the VGG in batches of ``batch_size``, the last one
padded by repeating its last example so every step has one shape, on the
device loop of the other families (``BaseExtractor.run_batches``; with
``data_parallel`` each batch splits over the local devices, the VGG and
the PCA buffers copied to each). The output is ``{'vggish': (Ta, 128)}``,
float32, or uint8 with ``post_process``.
"""
from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Tuple

import numpy as np
import torch

from video_features_torch.cache.key import run_fingerprint
from video_features_torch.config import check_vggish_args
from video_features_torch.extract.base import BaseExtractor
from video_features_torch.models import vggish as vggish_model
from video_features_torch.ops.audio import SAMPLE_RATE, waveform_to_examples
from video_features_torch.ops.nn import three_pass_route
from video_features_torch.ops.precision import features_to_f32
from video_features_torch.transplant import flatten

BATCH = 32      # examples per device step (a 30 s clip is ~31 examples)


def vggish_program(params, examples: torch.Tensor, model, dtype,
                   three_pass_convs: bool = False):
    """:meth:`ExtractVGGish.packed_step` with ``model``'s state
    ``params`` passed in: ``(B, 1, 96, 64)`` examples → (B, 128)
    float32, every convolution in 3xTF32 under ``three_pass_convs``."""
    with three_pass_route(three_pass_convs):
        return features_to_f32(torch.func.functional_call(
            model, params, (examples.to(dtype),)))


class ExtractVGGish(BaseExtractor):

    _device_state_attrs = ('model', '_pca_eig', '_pca_means')

    def __init__(self, args) -> None:
        super().__init__(args)
        check_vggish_args(args)
        if args.get('show_pred'):
            raise NotImplementedError('vggish has no show_pred: run with '
                                      'show_pred=false')
        self.output_feat_keys = [self.feature_type]
        self.batch_size = int(args.get('batch_size') or BATCH)
        self.audio_backend = args.get('audio_backend') or 'auto'
        self.post_process = bool(args.get('post_process', False))
        self.run_fingerprint = run_fingerprint(args)
        # on the bf16 lane the params load bf16 and the examples narrow to
        # bf16 on the host, before the copy (half the bytes)
        self.model = vggish_model.build(flatten(self.load_params(args)),
                                        self.device)
        if self.post_process:
            with np.load(args['pca_params_path']) as pca:
                eig = pca['pca_eigen_vectors'].astype(np.float32)
                means = pca['pca_means'].astype(np.float32).reshape(-1)
            self._pca_eig = torch.from_numpy(eig).to(self.device)
            self._pca_means = torch.from_numpy(means).to(self.device)
        if self.data_parallel:
            self._ensure_mesh('batch_size')

    def load_params(self, args):
        from video_features_torch.extract.weights import load_or_init
        return load_or_init(args, 'checkpoint_path',
                            vggish_model.init_state_dict, feature_type='vggish',
                            compute_dtype=self.compute_dtype)

    def _read_audio(self, video_path: str) -> Tuple[np.ndarray, int, tuple]:
        """``(waveform, sample rate, temp files to remove)`` for a .wav or
        an .mp4."""
        from video_features_torch.io import native, video
        from video_features_torch.io.audio import extract_wav_from_mp4, read_wav

        ext = Path(video_path).suffix
        if ext == '.wav':
            data, sr = read_wav(video_path)
            return data, sr, ()
        if ext != '.mp4':
            raise NotImplementedError(f'unsupported extension {ext}: vggish '
                                      'reads .wav and .mp4')
        backend = self.audio_backend
        if backend == 'auto':
            if video.which_ffmpeg():
                backend = 'ffmpeg'
            elif native.available():
                backend = 'native'
            else:
                raise RuntimeError(
                    'no mp4 audio backend available: install an ffmpeg '
                    'binary (audio_backend=ffmpeg) or g++ and the libav '
                    'development packages for the in-process decoder '
                    '(audio_backend=native)')
        if backend == 'native':
            if not native.available():
                raise RuntimeError(
                    'audio_backend=native but the native decode library '
                    '(native/libvfdecode.so) did not build or load: install '
                    'g++ and the libav development packages, or use '
                    'audio_backend=ffmpeg')
            data, sr = native.read_audio_native(video_path, SAMPLE_RATE)
            return data.astype(np.float64), sr, ()
        wav_path, aac_path = extract_wav_from_mp4(video_path, self.tmp_path)
        try:
            data, sr = read_wav(wav_path)
        except Exception:
            self._remove((wav_path, aac_path))
            raise
        return data, sr, (wav_path, aac_path)

    def _remove(self, paths) -> None:
        if not self.keep_tmp_files:
            for p in paths:
                if p and os.path.exists(p):
                    os.remove(p)

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        tmp_files: tuple = ()
        try:
            data, sr, tmp_files = self._read_audio(video_path)
            examples = waveform_to_examples(data, sr)       # (N, 96, 64) f64
            # the DSP is float64 by design, the VGG float32: narrow here
            feats = self._run_batched(examples.astype(np.float32)[:, None])
            if self.post_process:
                with torch.inference_mode(), self.precision_scope():
                    feats = vggish_model.postprocess(
                        self._pca_eig, self._pca_means,
                        torch.from_numpy(feats).to(self.device)
                    ).cpu().numpy().astype(np.uint8)
        finally:
            self._remove(tmp_files)
        return {self.feature_type: feats}

    def _run_batched(self, examples: np.ndarray) -> np.ndarray:
        """``(N, 1, 96, 64)`` float32 examples → ``(N, 128)`` embeddings,
        ``batch_size`` per step; zero examples make no device call."""
        n = examples.shape[0]
        if n == 0:
            return np.zeros((0, vggish_model.FEAT_DIM), np.float32)

        def batches():
            for start in range(0, n, self.batch_size):
                chunk = examples[start:start + self.batch_size]
                valid = chunk.shape[0]
                if valid < self.batch_size:
                    pad = np.repeat(chunk[-1:], self.batch_size - valid, axis=0)
                    chunk = np.concatenate([chunk, pad], axis=0)
                yield chunk, valid

        return np.concatenate([out[self.feature_type][:valid] for out, _, valid
                               in self.run_batches(batches())], axis=0)

    def packed_step(self, examples: torch.Tensor) -> Dict[str, torch.Tensor]:
        """``(B, 1, 96, 64)`` float32 examples on the device → {'vggish':
        (B, 128)} float32, the VGG run in the lane's dtype (its six
        convolutions in 3xTF32 under ``high`` and ``mixed``)."""
        with three_pass_route(self.three_pass_convs):
            return {self.feature_type: features_to_f32(
                self.model(examples.to(self.act_dtype)))}

    def program_specs(self, mesh=None):
        """The step's program: one batch of ``batch_size`` examples
        (rounded up to the mesh's data axis, the global batch
        ``data_parallel`` steps at) through :meth:`packed_step`'s VGG,
        its state passed in (``torch.func.functional_call``)."""
        b = self.batch_size
        if mesh is not None:
            from video_features_torch.parallel.mesh import (
                round_batch_to_data_axis,
            )
            b = round_batch_to_data_axis(b, mesh)
        return [self._program_spec(
            'step', vggish_program, (b, 1, 96, 64), torch.float32, mesh,
            params=dict(self.model.state_dict()),
            kwargs=dict(model=self.model, dtype=self.act_dtype,
                        three_pass_convs=self.three_pass_convs))]
