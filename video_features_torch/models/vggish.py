"""VGGish, the AudioSet VGG behind the reference's vendored torchvggish
net, port of ``video_features_tpu/models/vggish.py``.

:class:`VGGish` is an ``nn.Module`` on NCHW log-mel examples ``(B, 1, 96,
64)`` whose ``state_dict`` carries torchvggish's names, so a torchvggish
checkpoint loads as it is: four conv stages [64, M, 128, M, 256×2, M,
512×2, M] of 3×3/pad-1 convs + ReLU (``features.{0,3,6,8,11,13}``) with
2×2 max pools, then linears 12288 → 4096 → 4096 → 128
(``embeddings.{0,2,4}``) with a ReLU after every one, the last included.

torchvggish flattens its (B, 512, 6, 4) map channels-last (two
transposes); :meth:`VGGish.forward` does the same with a permute. A plain
``flatten(1)`` has the same width and computes something else.

Inside an ``ops/nn.py::conv_route`` (``precision=high`` and ``mixed``,
the three-pass lane) the forward runs channels-last instead, its six
convolutions with their biases through ``ops/nn.py::conv`` (the 3xTF32
convolution; the 1-channel input padded to 4 there, one copy), the pools
through ``ops/nn.py::max_pool``, and the (B, 6, 4, 512) map flattens as it
lies, which is torchvggish's order; the linears stay in cuBLAS. Outside a
route the module's own layers run, as before.

:func:`postprocess` is the AudioSet release's PCA-whiten + 8-bit
quantization, which the reference's default path bypasses.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch
import torch.nn as nn

from video_features_torch.ops import nn as nn_ops

FEAT_DIM = 128
# torch make_layers(): ints are 3x3 convs + ReLU, 'M' a 2x2 max pool
LAYERS = (64, 'M', 128, 'M', 256, 256, 'M', 512, 512, 'M')
# (Sequential index, out channels) of the convs
CONV_LAYERS = ((0, 64), (3, 128), (6, 256), (8, 256), (11, 512), (13, 512))
EMBED_DIMS = ((512 * 6 * 4, 4096), (4096, 4096), (4096, FEAT_DIM))


class VGGish(nn.Module):
    """``(B, 1, 96, 64)`` log-mel examples → ``(B, 128)`` embeddings."""

    def __init__(self) -> None:
        super().__init__()
        layers, in_ch = [], 1
        for v in LAYERS:
            if v == 'M':
                layers.append(nn.MaxPool2d(2, 2))
            else:
                layers += [nn.Conv2d(in_ch, v, 3, padding=1), nn.ReLU()]
                in_ch = v
        self.features = nn.Sequential(*layers)
        embeddings = []
        for fan_in, fan_out in EMBED_DIMS:
            embeddings += [nn.Linear(fan_in, fan_out), nn.ReLU()]
        self.embeddings = nn.Sequential(*embeddings)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if nn_ops.conv_route_active():
            return self.embeddings(self._routed_features(x))
        x = self.features(x)                      # (B, 512, 6, 4)
        x = x.permute(0, 2, 3, 1).flatten(1)      # torchvggish's flatten
        return self.embeddings(x)

    def _routed_features(self, x: torch.Tensor) -> torch.Tensor:
        """``features`` channels-last through ``ops/nn.py``'s conv route,
        flattened in torchvggish's order: (B, 1, 96, 64) → (B, 12288)."""
        x = x.permute(0, 2, 3, 1)                 # (B, 96, 64, 1)
        for layer in self.features:
            if isinstance(layer, nn.Conv2d):
                x = nn_ops.relu(nn_ops.conv(x, layer.weight, padding=1,
                                            bias=layer.bias))
            elif isinstance(layer, nn.MaxPool2d):
                x = nn_ops.max_pool(x, 2)
        return x.flatten(1)                       # (B, 6, 4, 512) as it lies


def build(state_dict: Mapping[str, torch.Tensor], device) -> VGGish:
    """A :class:`VGGish` in eval mode on ``device`` holding
    ``state_dict`` (strict: every torchvggish name, nothing else); no
    random init is computed for weights about to be replaced."""
    with torch.device('meta'):
        model = VGGish()
    model.load_state_dict(dict(state_dict), strict=True, assign=True)
    return model.to(device).eval()


def postprocess(pca_eigen_vectors: torch.Tensor, pca_means: torch.Tensor,
                embeddings: torch.Tensor, quant_min: float = -2.0,
                quant_max: float = 2.0) -> torch.Tensor:
    """AudioSet PCA-whiten + 8-bit quantization: the values 0..255 as
    floats, rounded half to even (as ``jnp.round``)."""
    x = (embeddings - pca_means.reshape(1, -1)) @ pca_eigen_vectors.T
    x = x.clamp(quant_min, quant_max)
    return torch.round((x - quant_min) * (255.0 / (quant_max - quant_min)))


def init_state_dict(seed: int = 0) -> Dict[str, np.ndarray]:
    """Random torch-layout state_dict with torchvggish naming and shapes
    (a copy of the JAX package's, so one seed gives the same numbers)."""
    rng = np.random.RandomState(seed)
    sd: Dict[str, np.ndarray] = {}
    in_ch = 1
    for idx, out_ch in CONV_LAYERS:
        sd[f'features.{idx}.weight'] = (
            rng.randn(out_ch, in_ch, 3, 3).astype(np.float32) * 0.05)
        sd[f'features.{idx}.bias'] = rng.randn(out_ch).astype(np.float32) * 0.05
        in_ch = out_ch
    for i, (fan_in, fan_out) in zip(('0', '2', '4'), EMBED_DIMS):
        sd[f'embeddings.{i}.weight'] = (
            rng.randn(fan_out, fan_in).astype(np.float32) * 0.01)
        sd[f'embeddings.{i}.bias'] = rng.randn(fan_out).astype(np.float32) * 0.01
    return sd
