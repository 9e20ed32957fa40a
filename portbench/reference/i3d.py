"""Plain I3D (Inception-v1 inflated to 3-D; Carreira & Zisserman 2017),
channels-first float32, as the kinetics-i3d PyTorch transplant that
video_features runs (hassony2/kinetics_i3d_pytorch):

  * Unit3D: TF 'SAME' padding as a constant zero pad of max(k - s, 0),
    split low = pad // 2, high = the rest; conv without bias; batch norm
    (eps 1e-5); ReLU;
  * max pools: the same zero pad, then a ceil-mode pool;
  * nine Mixed blocks, a (2, 7, 7) stride-1 average pool, and the
    feature head: the mean over the remaining time steps, 1024-d.

Weights are a state dict in that transplant's naming.
"""
from __future__ import annotations

from typing import List, Tuple

import torch
import torch.nn.functional as F

FEAT_DIM = 1024

# name -> (in, [b0, b1_mid, b1_out, b2_mid, b2_out, b3])
MIXED = {
    'mixed_3b': (192, [64, 96, 128, 16, 32, 32]),
    'mixed_3c': (256, [128, 128, 192, 32, 96, 64]),
    'mixed_4b': (480, [192, 96, 208, 16, 48, 64]),
    'mixed_4c': (512, [160, 112, 224, 24, 64, 64]),
    'mixed_4d': (512, [128, 128, 256, 24, 64, 64]),
    'mixed_4e': (512, [112, 144, 288, 32, 64, 64]),
    'mixed_4f': (528, [256, 160, 320, 32, 128, 128]),
    'mixed_5b': (832, [256, 160, 320, 32, 128, 128]),
    'mixed_5c': (832, [384, 192, 384, 48, 128, 128]),
}


def leaves(modality: str) -> List[Tuple[str, tuple, str]]:
    """Every weight the feature head reads: (name, shape, kind)."""
    out = []

    def unit(name, i, o, k):
        k = (k, k, k) if isinstance(k, int) else k
        out.append((f'{name}.conv3d.weight', (o, i) + k, 'conv'))
        for leaf, kind in (('weight', 'bn_weight'), ('bias', 'bn_bias'),
                           ('running_mean', 'bn_mean'),
                           ('running_var', 'bn_var')):
            out.append((f'{name}.batch3d.{leaf}', (o,), kind))

    unit('conv3d_1a_7x7', 3 if modality == 'rgb' else 2, 64, 7)
    unit('conv3d_2b_1x1', 64, 64, 1)
    unit('conv3d_2c_3x3', 64, 192, 3)
    for name, (cin, (b0, b1m, b1o, b2m, b2o, b3)) in MIXED.items():
        unit(f'{name}.branch_0', cin, b0, 1)
        unit(f'{name}.branch_1.0', cin, b1m, 1)
        unit(f'{name}.branch_1.1', b1m, b1o, 3)
        unit(f'{name}.branch_2.0', cin, b2m, 1)
        unit(f'{name}.branch_2.1', b2m, b2o, 3)
        unit(f'{name}.branch_3.1', cin, b3, 1)
    # the classifier, which the feature head never reads
    out.append(('conv3d_0c_1x1.conv3d.weight', (400, 1024, 1, 1, 1), 'conv'))
    out.append(('conv3d_0c_1x1.conv3d.bias', (400,), 'bias'))
    return out


def _same_pad(kernel, stride):
    """F.pad's spec (last dim first) of the TF 'SAME' zero pad."""
    spec = []
    for k, s in reversed(list(zip(kernel, stride))):
        p = max(k - s, 0)
        spec += [p // 2, p - p // 2]
    return spec


def unit(sd, name, x, kernel, stride=(1, 1, 1)):
    kernel = (kernel,) * 3 if isinstance(kernel, int) else kernel
    x = F.conv3d(F.pad(x, _same_pad(kernel, stride)),
                 sd[f'{name}.conv3d.weight'], None, stride)
    x = F.batch_norm(x, sd[f'{name}.batch3d.running_mean'],
                     sd[f'{name}.batch3d.running_var'],
                     sd[f'{name}.batch3d.weight'], sd[f'{name}.batch3d.bias'],
                     False, 0.0, 1e-5)
    return F.relu(x)


def max_pool(x, kernel, stride):
    return F.max_pool3d(F.pad(x, _same_pad(kernel, stride)), kernel, stride,
                        ceil_mode=True)


def mixed(sd, name, x):
    b0 = unit(sd, f'{name}.branch_0', x, 1)
    b1 = unit(sd, f'{name}.branch_1.1', unit(sd, f'{name}.branch_1.0', x, 1), 3)
    b2 = unit(sd, f'{name}.branch_2.1', unit(sd, f'{name}.branch_2.0', x, 1), 3)
    b3 = unit(sd, f'{name}.branch_3.1', max_pool(x, (3, 3, 3), (1, 1, 1)), 1)
    return torch.cat([b0, b1, b2, b3], dim=1)


def features(sd, x: torch.Tensor) -> torch.Tensor:
    """(N, C, T, 224, 224) in [-1, 1] → (N, 1024)."""
    x = unit(sd, 'conv3d_1a_7x7', x, 7, (2, 2, 2))
    x = max_pool(x, (1, 3, 3), (1, 2, 2))
    x = unit(sd, 'conv3d_2b_1x1', x, 1)
    x = unit(sd, 'conv3d_2c_3x3', x, 3)
    x = max_pool(x, (1, 3, 3), (1, 2, 2))
    x = mixed(sd, 'mixed_3b', x)
    x = mixed(sd, 'mixed_3c', x)
    x = max_pool(x, (3, 3, 3), (2, 2, 2))
    for name in ('mixed_4b', 'mixed_4c', 'mixed_4d', 'mixed_4e', 'mixed_4f'):
        x = mixed(sd, name, x)
    x = max_pool(x, (2, 2, 2), (2, 2, 2))
    x = mixed(sd, 'mixed_5b', x)
    x = mixed(sd, 'mixed_5c', x)
    x = F.avg_pool3d(x, (2, x.shape[3], x.shape[4]), stride=1)
    return x.flatten(2).mean(dim=2)
