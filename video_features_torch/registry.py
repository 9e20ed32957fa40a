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

# the families whose every convolution runs in the hand 3xTF32 convolution
# (ops/conv_tf32x3.py) under precision=high and mixed, the JAX package's
# three passes (utils/device.py::three_pass_convs), and the precision
# values that run them; of them, the families whose every linear, attention
# product and raw matmul runs in the hand 3xTF32 GEMM (ops/gemm_tf32x3.py)
# and every depthwise convolution in the fp32 one (ops/dwconv.py) too
THREE_PASS_FEATURES = frozenset(
    {'i3d', 'raft', 'r21d', 's3d', 'resnet', 'vggish', 'clip', 'timm'})
THREE_PASS_PRODUCT_FEATURES = frozenset({'clip', 'timm'})
THREE_PASS_PRECISIONS = ('high', 'mixed')

# the families that accept precision=mixed: those whose feature rel L2
# under mixed against highest the card measured at <= 1e-3, on seeded
# weights and the chip_smoke.py inputs (its 'precision lanes' phase):
# every convolution in 3xTF32 (for THREE_PASS_PRODUCT_FEATURES every
# product too) with the libraries in fp32; the others refuse it with the
# figure (MIXED_REFUSALS, empty since every family measured under the bar)
MIXED_FEATURES = frozenset({
    'resnet',   # resnet50: 1.126e-06 at batch 1, 1.123e-06 at batch 32;
                # resnext50_32x4d at batch 32: 4.138e-07 (three passes)
    'clip',     # ViT-B/32: 1.213e-06 at batch 8, 1.208e-06 at batch 32;
                # RN50 at batch 8: 9.451e-07 (three passes)
    'timm',     # vit_base_patch16_224: 2.189e-06 at batch 8, 2.141e-06 at
                # 32; one arch of every other family at batch 8:
                # 3.977e-07 (mixer_b16_224) to 1.605e-06 (deit_base_distilled)
                # (three passes)
    'r21d',     # r2plus1d_18 at batch 4: 4.650e-06 (three passes)
    's3d',      # one 64-frame stack: 2.014e-06 (three passes)
    'vggish',   # batch 32: 1.875e-06 (three passes)
    'i3d',      # the fused step at batch 8: flow 6.773e-05, rgb 3.154e-06
    'raft',     # 8 pairs, 20 iterations: 2.763e-04 (max over flow fields)
})  # NVIDIA H100 80GB HBM3, 700.00 W
MIXED_REFUSALS: Dict[str, str] = {}


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
