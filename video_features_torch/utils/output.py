"""Output pathing and serialization (copy of ``video_features_tpu/utils/
output.py``).

Writes are atomic: a same-directory tmp file, then ``os.replace``, so a
killed process never leaves a partial file at the final path. Beside a
video's outputs, ``<stem>_fingerprint.json`` records the run fingerprint
(config + weights identity) that produced them; resume re-extracts when
it differs.
"""
from __future__ import annotations

import json
import os
import pickle
import tempfile
from pathlib import Path
from typing import Any, Callable, Optional

import numpy as np


class CorruptOutputError(RuntimeError):
    """A saved output file exists but cannot be read back."""


def make_path(output_root: str, video_path: str, output_key: str, ext: str) -> str:
    """``<out>/<stem><ext>`` for key 'rgb', else ``<out>/<stem>_<key><ext>``
    (the no-suffix 'rgb' case is the fork's name for the concatenated
    I3D feature)."""
    stem = Path(video_path).stem
    fname = f'{stem}{ext}' if output_key == 'rgb' else f'{stem}_{output_key}{ext}'
    return os.path.join(output_root, fname)


def _umask() -> int:
    mask = os.umask(0)
    os.umask(mask)
    return mask


def atomic_write(fpath: str, write_fn: Callable) -> None:
    """``write_fn(binary_file)`` fills a tmp file in the target's
    directory, then one rename publishes it; any failure removes the tmp."""
    d = os.path.dirname(fpath) or '.'
    fd, tmp = tempfile.mkstemp(dir=d, prefix=Path(fpath).name + '.',
                               suffix='.tmp')
    try:
        os.fchmod(fd, 0o666 & ~_umask())
        with os.fdopen(fd, 'wb') as f:
            write_fn(f)
        os.replace(tmp, fpath)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_numpy(fpath: str) -> np.ndarray:
    if os.path.getsize(fpath) == 0:
        raise CorruptOutputError(f'empty output file: {fpath}')
    try:
        return np.load(fpath)
    except FileNotFoundError:
        raise
    except (ValueError, EOFError, OSError, pickle.UnpicklingError) as e:
        raise CorruptOutputError(
            f'corrupt/truncated .npy file: {fpath} ({e})') from e


def write_numpy(fpath: str, value: Any) -> None:
    atomic_write(fpath, lambda f: np.save(f, value))


def load_pickle(fpath: str) -> Any:
    """Reads only files this package wrote (unpickling runs code)."""
    if os.path.getsize(fpath) == 0:
        raise CorruptOutputError(f'empty output file: {fpath}')
    try:
        with open(fpath, 'rb') as f:
            return pickle.load(f)
    except FileNotFoundError:
        raise
    except (ValueError, EOFError, OSError, pickle.UnpicklingError,
            AttributeError, ImportError, IndexError) as e:
        raise CorruptOutputError(
            f'corrupt/truncated .pkl file: {fpath} ({e})') from e


def write_pickle(fpath: str, value: Any) -> None:
    atomic_write(fpath, lambda f: pickle.dump(value, f))


ACTION_TO_EXT = {'save_numpy': '.npy', 'save_pickle': '.pkl'}
ACTION_TO_SAVE = {'save_numpy': write_numpy, 'save_pickle': write_pickle}
ACTION_TO_LOAD = {'save_numpy': load_numpy, 'save_pickle': load_pickle}


def fingerprint_path(output_root: str, video_path: str) -> str:
    return make_path(output_root, video_path, 'fingerprint', '.json')


def write_fingerprint(output_root: str, video_path: str,
                      fingerprint: str) -> None:
    atomic_write(
        fingerprint_path(output_root, video_path),
        lambda f: f.write(json.dumps(
            {'fingerprint': fingerprint}).encode('utf-8')))


def read_fingerprint(output_root: str, video_path: str) -> Optional[str]:
    """The recorded fingerprint, or None when absent or unreadable."""
    try:
        with open(fingerprint_path(output_root, video_path),
                  encoding='utf-8') as f:
            return json.load(f).get('fingerprint')
    except (OSError, ValueError):
        return None
