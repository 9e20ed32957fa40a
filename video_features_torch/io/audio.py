"""Audio demux and wav reading for vggish, a copy of
``video_features_tpu/io/audio.py``.

:func:`extract_wav_from_mp4` is the reference's two-stage mp4 → .aac
(stream copy) → .wav chain through the ffmpeg binary, with list-argv
calls (paths with spaces survive); :func:`read_wav` reads PCM with the
standard library's ``wave`` module.
"""
from __future__ import annotations

import subprocess
import wave
from pathlib import Path
from typing import Tuple

import numpy as np

from video_features_torch.io.video import which_ffmpeg


def extract_wav_from_mp4(video_path: str, tmp_path: str) -> Tuple[str, str]:
    """mp4 → aac (codec copy) → wav in ``tmp_path``; returns ``(wav_path,
    aac_path)``. Raises ``RuntimeError`` without an ffmpeg binary, and
    when either stage fails (no or unsupported audio track)."""
    ffmpeg = which_ffmpeg()
    if not ffmpeg:
        raise RuntimeError('ffmpeg is not installed')
    if not video_path.endswith('.mp4'):
        raise ValueError(f'expected an .mp4 file; got {video_path}')
    Path(tmp_path).mkdir(parents=True, exist_ok=True)

    stem = Path(video_path).stem
    aac_path = str(Path(tmp_path) / f'{stem}.aac')
    wav_path = str(Path(tmp_path) / f'{stem}.wav')

    for cmd in ([ffmpeg, '-hide_banner', '-loglevel', 'error', '-y',
                 '-i', video_path, '-acodec', 'copy', aac_path],
                [ffmpeg, '-hide_banner', '-loglevel', 'error', '-y',
                 '-i', aac_path, wav_path]):
        result = subprocess.run(cmd, stderr=subprocess.PIPE, text=True)
        if result.returncode != 0:
            raise RuntimeError(
                f'audio demux failed (no/unsupported audio track in '
                f'{video_path}?): {" ".join(cmd)}\n{result.stderr.strip()}')
    return wav_path, aac_path


def read_wav(wav_path: str) -> Tuple[np.ndarray, int]:
    """PCM wav → (float64 waveform in [-1, 1] shaped (T,) or (T, C),
    rate): 16-bit / 32768 as the reference reads it, 32-bit / 2^31, and
    unsigned 8-bit centred on 128."""
    with wave.open(wav_path, 'rb') as f:
        rate = f.getframerate()
        n_channels = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(f.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype='<i2').astype(np.float64) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype='<i4').astype(np.float64) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
    else:
        raise NotImplementedError(f'unsupported wav sample width: {width}')
    if n_channels > 1:
        data = data.reshape(-1, n_channels)
    return data, rate
