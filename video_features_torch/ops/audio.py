"""Audio DSP: waveform → log-mel examples for VGGish, a copy of
``video_features_tpu/ops/audio.py`` (host numpy in float64, as in the
reference's preprocessing: ``mel_features.py`` and ``vggish_input.py``).

  * strided framing with floor-truncated tails, the periodic Hann
    window, the magnitude rFFT at the next power of two, an HTK
    triangular mel filterbank with a zeroed DC bin, log with offset 0.01,
    and 0.96 s non-overlapping 96×64 examples;
  * :func:`resample_kaiser`: resampy 0.4.2's ``kaiser_best`` (the
    reference resamples any non-16 kHz input with it), vectorized over
    output samples in chunks. ``method='polyphase'`` keeps scipy's
    ``resample_poly`` for comparison.

The VGG net is the device work; this stays on the host.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Optional

import numpy as np

SAMPLE_RATE = 16000
STFT_WINDOW_SECS = 0.025
STFT_HOP_SECS = 0.010
NUM_MEL_BINS = 64
MEL_MIN_HZ = 125.0
MEL_MAX_HZ = 7500.0
LOG_OFFSET = 0.01
EXAMPLE_WINDOW_SECS = 0.96
EXAMPLE_HOP_SECS = 0.96

_MEL_BREAK_HZ = 700.0
_MEL_HIGH_Q = 1127.0


def frame(data: np.ndarray, window_length: int, hop_length: int) -> np.ndarray:
    """(T, ...) → (num_frames, window_length, ...); incomplete tails dropped."""
    num_frames = 1 + int(np.floor((data.shape[0] - window_length) / hop_length))
    shape = (num_frames, window_length) + data.shape[1:]
    strides = (data.strides[0] * hop_length,) + data.strides
    return np.lib.stride_tricks.as_strided(data, shape=shape, strides=strides)


def periodic_hann(window_length: int) -> np.ndarray:
    """Full-cycle (period-N) raised cosine — NOT numpy's symmetric hanning."""
    return 0.5 - 0.5 * np.cos(2 * np.pi / window_length
                              * np.arange(window_length))


def stft_magnitude(signal: np.ndarray, fft_length: int, hop_length: int,
                   window_length: int) -> np.ndarray:
    frames = frame(signal, window_length, hop_length)
    return np.abs(np.fft.rfft(frames * periodic_hann(window_length),
                              int(fft_length)))


def hertz_to_mel(frequencies_hertz):
    return _MEL_HIGH_Q * np.log(1.0 + np.asarray(frequencies_hertz)
                                / _MEL_BREAK_HZ)


def mel_matrix(num_mel_bins: int = NUM_MEL_BINS,
               num_spectrogram_bins: int = 257,
               audio_sample_rate: float = SAMPLE_RATE,
               lower_edge_hertz: float = MEL_MIN_HZ,
               upper_edge_hertz: float = MEL_MAX_HZ) -> np.ndarray:
    """(num_spectrogram_bins, num_mel_bins) triangular HTK filterbank,
    linear in mel space, DC bin zeroed."""
    nyquist = audio_sample_rate / 2.0
    if not 0.0 <= lower_edge_hertz < upper_edge_hertz <= nyquist:
        raise ValueError('bad mel band edges')
    spec_mel = hertz_to_mel(np.linspace(0.0, nyquist, num_spectrogram_bins))
    edges = np.linspace(hertz_to_mel(lower_edge_hertz),
                        hertz_to_mel(upper_edge_hertz), num_mel_bins + 2)
    lower = (spec_mel[:, None] - edges[None, :-2]) / (edges[1:-1] - edges[:-2])
    upper = (edges[None, 2:] - spec_mel[:, None]) / (edges[2:] - edges[1:-1])
    weights = np.maximum(0.0, np.minimum(lower, upper))
    weights[0, :] = 0.0
    return weights


def log_mel_spectrogram(data: np.ndarray,
                        audio_sample_rate: float = SAMPLE_RATE) -> np.ndarray:
    window_length = int(round(audio_sample_rate * STFT_WINDOW_SECS))
    hop_length = int(round(audio_sample_rate * STFT_HOP_SECS))
    fft_length = 2 ** int(np.ceil(np.log(window_length) / np.log(2.0)))
    spec = stft_magnitude(data, fft_length, hop_length, window_length)
    mel = spec @ mel_matrix(num_spectrogram_bins=spec.shape[1],
                            audio_sample_rate=audio_sample_rate)
    return np.log(mel + LOG_OFFSET)


# resampy 0.4.2 kaiser_best filter parameters (resampy/filters.py
# sinc_window + the shipped kaiser_best.npz generation constants): 64
# zero-crossings, 2^9 table entries per crossing, Kaiser window
# beta 14.769656459379492, roll-off 0.9475937167399596.
KAISER_BEST = dict(num_zeros=64, precision=9,
                   beta=14.769656459379492, rolloff=0.9475937167399596)

_FILTER_CACHE: dict = {}


def sinc_window(num_zeros: int, precision: int, beta: float,
                rolloff: float) -> tuple:
    """Right wing of resampy's interpolation filter (filters.sinc_window):
    a roll-off-scaled sinc sampled at 2^precision points per zero
    crossing, tapered by the right half of a Kaiser window. Returns
    (interp_win, num_table)."""
    from scipy.signal.windows import kaiser
    num_table = 2 ** precision
    n = num_table * num_zeros
    sinc_win = rolloff * np.sinc(
        rolloff * np.linspace(0, num_zeros, num=n + 1, endpoint=True))
    taper = kaiser(2 * n + 1, beta)[n:]
    return taper * sinc_win, num_table


def _interp_tables(sample_ratio: float) -> tuple:
    """(interp_win, interp_delta, num_table) for one ratio — the filter is
    pre-scaled by the ratio when downsampling (anti-aliasing), and
    interp_delta holds first differences for linear interpolation between
    table entries (resampy core.resample)."""
    if 'kaiser_best' not in _FILTER_CACHE:
        _FILTER_CACHE['kaiser_best'] = sinc_window(**KAISER_BEST)
    win, num_table = _FILTER_CACHE['kaiser_best']
    if sample_ratio < 1:
        win = win * sample_ratio
    delta = np.zeros_like(win)
    delta[:-1] = np.diff(win)
    return win, delta, num_table


def resample_kaiser(data: np.ndarray, sr: int,
                    target_sr: int = SAMPLE_RATE) -> np.ndarray:
    """resampy-parity resampling (resampy 0.4.2 resample_f semantics,
    kaiser_best filter), vectorized over output samples in chunks.

    For each output time t (in input-sample units) the two filter wings
    accumulate ``win[offset + i*step] + eta*delta[...]`` against the
    input samples left/right of t — the exact windowed-sinc interpolation
    loop of resampy/interpn.py, with the per-output-sample inner loops
    turned into masked (chunk, taps) gathers. The literal-transcription
    mirror in tests/test_audio_resample.py pins equivalence."""
    ratio = Fraction(int(target_sr), int(sr))   # gcd-reduced, exact
    sample_ratio = float(ratio)
    n_in = data.shape[0]
    # resampy ≥0.4.0 output length: shape[axis] * sr_new // sr_orig
    # (integer floor — its 0.4.0 rounding fix); exact-int via the reduced
    # fraction, which floors identically.
    n_out = n_in * ratio.numerator // ratio.denominator
    win, delta, num_table = _interp_tables(sample_ratio)
    scale = min(1.0, sample_ratio)
    index_step = int(scale * num_table)
    nwin = win.shape[0]
    max_taps = nwin // index_step + 1
    out = np.zeros(n_out, dtype=np.float64)
    x = np.asarray(data, dtype=np.float64)
    taps = np.arange(max_taps)

    def wing(n, offset, eta, limit):
        """Masked gather-accumulate of one filter wing for a chunk:
        sum_i (win[offset + i*step] + eta*delta[...]) * x[n ± i]."""
        idx = offset[:, None] + taps[None, :] * index_step
        valid = taps[None, :] < limit[:, None]
        idx = np.minimum(idx, nwin - 1)
        w = (win[idx] + eta[:, None] * delta[idx]) * valid
        src = np.clip(n, 0, n_in - 1)
        return np.einsum('ct,ct->c', w, x[src])

    chunk = 1 << 15
    for start in range(0, n_out, chunk):
        t_idx = np.arange(start, min(start + chunk, n_out))
        time_register = t_idx / sample_ratio
        n = time_register.astype(np.int64)
        frac = scale * (time_register - n)
        index_frac = frac * num_table
        offset = index_frac.astype(np.int64)
        eta = index_frac - offset
        i_max = np.minimum(n + 1, (nwin - offset) // index_step)
        left = wing(n[:, None] - taps[None, :], offset, eta, i_max)
        frac_r = scale - frac
        index_frac = frac_r * num_table
        offset = index_frac.astype(np.int64)
        eta = index_frac - offset
        k_max = np.minimum(n_in - n - 1, (nwin - offset) // index_step)
        right = wing(n[:, None] + 1 + taps[None, :], offset, eta, k_max)
        out[t_idx] = left + right
    return out


def resample(data: np.ndarray, sr: int, target_sr: int = SAMPLE_RATE,
             method: str = 'kaiser_best') -> np.ndarray:
    """Resample to ``target_sr``. ``kaiser_best`` (default) is the
    reference-parity path; ``polyphase`` keeps the earlier scipy
    resampler for comparison."""
    if method == 'kaiser_best':
        return resample_kaiser(data, sr, target_sr)
    from scipy.signal import resample_poly
    ratio = Fraction(target_sr, sr)
    return resample_poly(data, ratio.numerator, ratio.denominator)


def waveform_to_examples(data: np.ndarray, sample_rate: int,
                         target_sr: Optional[int] = None) -> np.ndarray:
    """Waveform → (num_examples, 96, 64) float32 log-mel patches
    (reference vggish_input.py:26-74 semantics: mono-mean, resample to
    16 kHz, 0.96 s non-overlapping windows, tails dropped)."""
    if data.ndim > 1:
        data = data.mean(axis=1)
    target_sr = target_sr or SAMPLE_RATE
    if sample_rate != target_sr:
        data = resample(data, sample_rate, target_sr)
    log_mel = log_mel_spectrogram(data, target_sr)
    feats_rate = 1.0 / STFT_HOP_SECS
    window = int(round(EXAMPLE_WINDOW_SECS * feats_rate))
    hop = int(round(EXAMPLE_HOP_SECS * feats_rate))
    return frame(log_mel, window, hop).astype(np.float32)
