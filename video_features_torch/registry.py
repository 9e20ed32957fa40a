"""Extractor registry with lazy imports: :func:`create_extractor` points
the kernel builds at the config's ``compilation_cache_dir``, builds a
family's extractor from its merged config, resolves its ``mesh_devices``
and attaches the feature cache, the executable store and the flight
recorder the config asks for."""
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

# the families that split their batches over the local devices
# (data_parallel), as in the JAX package: an explicit set, so a family
# added later warns and runs on one device until it opts in
DATA_PARALLEL_FEATURES = frozenset(
    {'i3d', 'r21d', 's3d', 'vggish', 'resnet', 'raft', 'clip', 'timm'})

# the families with a packed loop (pack_across_videos), as in the JAX package
PACKED_FEATURES = ('i3d', 'r21d', 's3d', 'resnet', 'clip', 'timm')

# the families that accept compute_dtype=bfloat16 and compute_dtype=int8,
# as in the JAX package (ops/precision.py holds their bounds and the
# refusals of the others)
BF16_FEATURES = frozenset({'r21d', 's3d', 'resnet', 'clip', 'timm', 'vggish'})
INT8_FEATURES = frozenset({'resnet', 'clip', 'timm'})

# the families a live session (ingress/) can feed: raw network frames
# windowed to the family's packed geometry (BaseExtractor.live_window_spec),
# as in the JAX package; a family opts in here and returns a spec, or the
# daemon refuses the session up front
LIVE_FEATURES = frozenset({'i3d', 'r21d', 's3d', 'resnet', 'clip', 'timm'})

# the families that accept precision=mixed: those whose feature rel L2
# under mixed (TF32 in cuDNN and cuBLAS, the GRU kernel in 3xTF32) against
# highest the card measured at <= 1e-3, on seeded weights and the
# chip_smoke.py inputs (its 'precision lanes' phase); the others refuse it
# with the figure (MIXED_REFUSALS)
MIXED_FEATURES = frozenset({
    'resnet',   # resnet50: 3.736e-04 at batch 1, 3.683e-04 at batch 32
    'clip',     # ViT-B/32: 3.928e-04 at batch 1, 4.799e-04 at batch 32
    'timm',     # vit_base_patch16_224: 8.668e-04 at batch 1, 8.308e-04 at 32
    'r21d',     # r2plus1d_18 at batch 4: 4.840e-04
    's3d',      # one 64-frame stack: 3.908e-04
    'vggish',   # batch 32: 7.003e-04
})  # NVIDIA H100 80GB HBM3, 700.00 W
MIXED_REFUSALS = {
    'i3d': ('the card measured its flow stream at 6.714e-03 rel L2 against '
            'highest under mixed (rgb 5.185e-04; the fused step at batch 8, '
            'RAFT 20 iterations, then the flow\'s uint8 quantization), over '
            'the 1e-3 bar (NVIDIA H100 80GB HBM3, 700.00 W)'),
    'raft': ('the card measured its raw flow at up to 3.794e-02 rel L2 per '
             'flow field against highest under mixed (8 pairs, 20 '
             'iterations), over the 1e-3 bar (NVIDIA H100 80GB HBM3, '
             '700.00 W)'),
}


def create_extractor(args):
    feature_type = args['feature_type']
    try:
        module_name, class_name = EXTRACTORS[feature_type]
    except KeyError:
        raise NotImplementedError(f'Unknown feature_type {feature_type!r}. '
                                  f'Known: {", ".join(EXTRACTORS)}')
    from video_features_torch.ops._kernels import configure_build_dir
    configure_build_dir(args.get('compilation_cache_dir'))
    extractor = getattr(importlib.import_module(module_name), class_name)(args)
    extractor.configure_mesh(args)
    extractor.configure_cache(args)
    extractor.configure_aot(args)
    extractor.configure_obs(args)
    return extractor
