"""BaseExtractor: per-video orchestration, fault isolation, idempotent
output (a slim port of ``video_features_tpu/extract/base.py``).

  * ``_extract`` = skip-if-exists → ``extract()`` → optional rgb||flow
    concat → ``action_on_extraction``; any exception is isolated per
    video (KeyboardInterrupt re-raised), reported on stderr with
    "Continuing...", so one bad file never kills the worklist;
  * ``action_on_extraction`` prints (with max/mean/min) or saves
    numpy/pickle atomically, and writes the run-fingerprint sidecar;
  * ``is_already_exist`` requires every output file present *and
    loadable*, and a recorded fingerprint equal to this run's: the
    family's feature-shaping config values and its checkpoints' content
    (:func:`run_fingerprint`).
"""
from __future__ import annotations

import hashlib
import json
import os
import sys
import traceback
import warnings
from pathlib import Path
from typing import Any, Dict, Iterable, List, Mapping, Union

import numpy as np

from video_features_torch.utils.device import resolve_device, set_precision
from video_features_torch.utils.fingerprint import (
    is_file_key, weights_fingerprint,
)
from video_features_torch.utils.output import (
    ACTION_TO_EXT, ACTION_TO_LOAD, ACTION_TO_SAVE, CorruptOutputError,
    make_path, read_fingerprint, write_fingerprint,
)

ACTIONS = ('print',) + tuple(ACTION_TO_EXT)

# per family, the config values that shape its features (the resume
# fingerprint); a *checkpoint_path key and pca_params_path enter by their
# file's content
FINGERPRINT_KEYS = {
    'i3d': ('feature_type', 'streams', 'flow_type', 'stack_size', 'step_size',
            'raft_iters', 'extraction_fps', 'concat_rgb_flow', 'precision',
            'i3d_rgb_checkpoint_path', 'i3d_flow_checkpoint_path',
            'raft_checkpoint_path', 'device_resize'),
    'r21d': ('feature_type', 'model_name', 'stack_size', 'step_size',
             'extraction_fps', 'precision', 'checkpoint_path'),
    's3d': ('feature_type', 'stack_size', 'step_size', 'extraction_fps',
            'precision', 'checkpoint_path'),
    'raft': ('feature_type', 'extraction_fps', 'extraction_total',
             'side_size', 'resize_to_smaller_edge', 'finetuned_on',
             'bucket_multiple', 'raft_iters', 'precision', 'checkpoint_path'),
    'resnet': ('feature_type', 'model_name', 'extraction_fps',
               'extraction_total', 'precision', 'checkpoint_path'),
    'clip': ('feature_type', 'model_name', 'extraction_fps',
             'extraction_total', 'precision', 'checkpoint_path'),
    'timm': ('feature_type', 'model_name', 'extraction_fps',
             'extraction_total', 'image_size', 'precision', 'checkpoint_path'),
    'vggish': ('feature_type', 'precision', 'checkpoint_path', 'audio_backend',
               'post_process', 'pca_params_path'),
}


def run_fingerprint(args: Any, keys: Iterable[str]) -> str:
    """sha256 of the config values among ``keys`` that shape a run's
    features, file path strings left out, and of those files' content
    (:func:`~video_features_torch.utils.fingerprint.weights_fingerprint`)."""
    keys = sorted(keys)
    blob = json.dumps({k: args.get(k) for k in keys if not is_file_key(k)},
                      sort_keys=True, default=str)
    cfg = hashlib.sha256(blob.encode('utf-8')).hexdigest()
    return hashlib.sha256(
        f'cfg:{cfg}|w:{weights_fingerprint(args, keys)}'.encode()).hexdigest()


class BaseExtractor:
    """Common per-video orchestration inherited by every extractor."""

    output_feat_keys: List[str] = []

    def __init__(self, args: Mapping[str, Any]) -> None:
        """The settings every family shares, read from the run's config
        ``args`` with their defaults here."""
        on_extraction = args.get('on_extraction', 'print')
        if on_extraction not in ACTIONS:
            raise ValueError(f'on_extraction must be one of {ACTIONS}; got '
                             f'{on_extraction!r}')
        self.feature_type = args['feature_type']
        self.on_extraction = on_extraction
        self.output_path = args['output_path']
        self.device = resolve_device(args.get('device', 'cuda'))
        set_precision(args.get('precision', 'highest'))
        self.concat_rgb_flow = bool(args.get('concat_rgb_flow', False))
        self.tmp_path = str(args.get('tmp_path', './tmp'))
        self.keep_tmp_files = bool(args.get('keep_tmp_files', False))
        self.decode_backend = args.get('decode_backend') or 'auto'
        self.run_fingerprint = None

    def video_loader(self, video_path: str, **kwargs):
        """A :class:`~video_features_torch.io.video.VideoLoader` that
        decodes with this run's ``decode_backend`` and re-encodes into its
        ``tmp_path`` (kept with ``keep_tmp_files``); use it as a context
        manager."""
        from video_features_torch.io.video import VideoLoader
        return VideoLoader(video_path, tmp_path=self.tmp_path,
                           keep_tmp=self.keep_tmp_files,
                           backend=self.decode_backend, **kwargs)

    def _extract(self, video_path: str) -> None:
        """Fault-isolating wrapper around :meth:`extract` for the work loop."""
        try:
            if self.is_already_exist(video_path):
                return
            feats_dict = self._maybe_concat_streams(self.extract(video_path))
            self.action_on_extraction(feats_dict, video_path)
        except KeyboardInterrupt:
            raise
        except Exception:
            traceback.print_exc()
            print(f'An error occurred during extraction of {video_path}. '
                  'Continuing...', file=sys.stderr)

    def extract(self, video_path: str) -> Dict[str, np.ndarray]:
        raise NotImplementedError

    def _maybe_concat_streams(self, feats_dict: Dict[str, np.ndarray]
                              ) -> Dict[str, np.ndarray]:
        """rgb||flow → one (T, 2C) array under 'rgb' when configured."""
        if self.concat_rgb_flow and 'rgb' in feats_dict and 'flow' in feats_dict:
            feats_dict = dict(feats_dict)
            flow = feats_dict.pop('flow')
            feats_dict['rgb'] = np.concatenate((feats_dict['rgb'], flow), axis=1)
        return feats_dict

    def action_on_extraction(self, feats_dict: Dict[str, np.ndarray],
                             video_path: str) -> None:
        if self.on_extraction in ACTION_TO_EXT and \
                self.is_already_exist(video_path):
            # a concurrent worker finished this video while we extracted it
            warnings.warn('extraction didnt find feature files on the 1st '
                          f'try but did on the 2nd try: {video_path}')
            return
        for key, value in feats_dict.items():
            if self.on_extraction == 'print':
                print(key)
                print(value)
                print(f'max: {value.max():.8f}; mean: {value.mean():.8f}; '
                      f'min: {value.min():.8f}')
                print()
                continue
            os.makedirs(self.output_path, exist_ok=True)
            fpath = make_path(self.output_path, video_path, key,
                              ACTION_TO_EXT[self.on_extraction])
            if np.ndim(value) and len(value) == 0:    # 'fps' is 0-d
                warnings.warn(f'the value is empty for {key} @ {fpath}')
            ACTION_TO_SAVE[self.on_extraction](fpath, value)
        if self.on_extraction in ACTION_TO_EXT \
                and self.run_fingerprint is not None:
            write_fingerprint(self.output_path, video_path,
                              self.run_fingerprint)

    def is_already_exist(self, video_path: Union[str, Path]) -> bool:
        """True iff every output file exists and loads cleanly, and no
        sidecar says a different config produced them."""
        if self.on_extraction not in ACTION_TO_EXT:
            return False
        for key in self._saved_feat_keys():
            fpath = make_path(self.output_path, video_path, key,
                              ACTION_TO_EXT[self.on_extraction])
            if not Path(fpath).exists():
                return False
            try:
                ACTION_TO_LOAD[self.on_extraction](fpath)
            except CorruptOutputError as e:
                warnings.warn(f'existing output failed to load; '
                              f're-extracting ({e})')
                return False
        recorded = read_fingerprint(self.output_path, video_path)
        if recorded is not None and self.run_fingerprint is not None \
                and recorded != self.run_fingerprint:
            warnings.warn(f'Existing outputs for {video_path} were produced '
                          'under a different config/checkpoint — '
                          're-extracting instead of reusing them')
            return False
        print(f'Features for {video_path} already exist in '
              f'{Path(self.output_path).absolute()}/ - skipping..')
        return True

    def _saved_feat_keys(self) -> List[str]:
        """Keys that reach disk: the concat folds 'flow' into 'rgb'."""
        keys = list(self.output_feat_keys)
        if self.concat_rgb_flow and 'rgb' in keys and 'flow' in keys:
            keys.remove('flow')
        return keys
