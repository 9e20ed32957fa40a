"""Shared helpers for building seeded random torch-layout state dicts
(a copy of ``video_features_tpu/models/_seed.py``, so both packages'
random inits give the same numbers).

Every timm-layout family exposes ``init_state_dict`` so tests and
``allow_random_weights`` runs can exercise the exact checkpoint tree
without real weights. The conv/bn entry writers live here once so all
families seed the same numeric regime (BN stats deliberately non-trivial
— fresh mean=0/var=1 would hide transplant bugs in those tensors).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np


class SeedWriter:
    """Writes torch-named conv / batch-norm entries into a state dict."""

    def __init__(self, sd: Dict[str, np.ndarray], rng: np.random.RandomState,
                 conv_scale: float = 0.1) -> None:
        self.sd, self.rng, self.conv_scale = sd, rng, conv_scale

    def conv(self, name: str, o: int, i: int, k: int,
             bias: bool = False, scale: Optional[float] = None) -> None:
        scale = self.conv_scale if scale is None else scale
        self.sd[f'{name}.weight'] = (
            self.rng.randn(o, i, k, k) * scale).astype(np.float32)
        if bias:
            self.sd[f'{name}.bias'] = (
                self.rng.randn(o).astype(np.float32) * 0.02)

    def dwconv(self, name: str, c: int, k: int) -> None:
        """Depthwise conv weight, torch layout (C, 1, k, k)."""
        self.sd[f'{name}.weight'] = (
            self.rng.randn(c, 1, k, k) * self.conv_scale).astype(np.float32)

    def bn(self, name: str, c: int) -> None:
        r = self.rng
        self.sd[f'{name}.weight'] = (r.rand(c) * 0.2 + 0.9).astype(np.float32)
        self.sd[f'{name}.bias'] = r.randn(c).astype(np.float32) * 0.02
        self.sd[f'{name}.running_mean'] = (r.randn(c) * 0.1).astype(np.float32)
        self.sd[f'{name}.running_var'] = (r.rand(c) + 0.5).astype(np.float32)

    def linear(self, name: str, o: int, i: int) -> None:
        self.sd[f'{name}.weight'] = (
            self.rng.randn(o, i) * 0.02).astype(np.float32)
        self.sd[f'{name}.bias'] = np.zeros(o, np.float32)
