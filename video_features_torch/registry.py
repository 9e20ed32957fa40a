"""Extractor registry with lazy imports."""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

EXTRACTORS: Dict[str, Tuple[str, str]] = {
    'i3d': ('video_features_torch.extract.i3d', 'ExtractI3D'),
    'r21d': ('video_features_torch.extract.r21d', 'ExtractR21D'),
    's3d': ('video_features_torch.extract.s3d', 'ExtractS3D'),
    'raft': ('video_features_torch.extract.raft', 'ExtractRAFT'),
    'resnet': ('video_features_torch.extract.resnet', 'ExtractResNet'),
    'clip': ('video_features_torch.extract.clip', 'ExtractCLIP'),
    'timm': ('video_features_torch.extract.timm', 'ExtractTIMM'),
    'vggish': ('video_features_torch.extract.vggish', 'ExtractVGGish'),
}

# the families with a packed loop (pack_across_videos), as in the JAX package
PACKED_FEATURES = ('i3d', 'r21d', 's3d', 'resnet', 'clip', 'timm')


def create_extractor(args):
    feature_type = args['feature_type']
    try:
        module_name, class_name = EXTRACTORS[feature_type]
    except KeyError:
        raise NotImplementedError(f'Unknown feature_type {feature_type!r}. '
                                  f'Known: {", ".join(EXTRACTORS)}')
    return getattr(importlib.import_module(module_name), class_name)(args)
