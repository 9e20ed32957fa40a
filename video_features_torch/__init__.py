"""PyTorch/CUDA port of video_features_tpu (NVIDIA Hopper).

The package mirrors the module layout of ``video_features_tpu`` and keeps
its channels-last layouts at every public function, so the two can be
compared tensor for tensor. It imports ``torch`` and never ``jax``, and
nothing of ``video_features_tpu``: what it needs from that package's
jax-free modules is copied here.

Ported so far, behind ``python -m video_features_torch
feature_type=<family>``: the fused I3D two-stream path (RAFT flow + both
I3D towers, ``i3d``, with the on-device bit-exact Pillow resize of
``device_resize=true``), the RAFT flow family (``raft``), the two
3-D CNN families R(2+1)D (``r21d``) and S3D (``s3d``), and the frame-wise
image families ResNet (``resnet``), CLIP (``clip``) and timm (``timm``),
and the VGGish audio family (``vggish``). Video decodes through the
in-process libav decoder where its library builds, else cv2
(``decode_backend``). Every RAFT
iteration on the card runs hand-written CUDA kernels: the
correlation-window lookup (``csrc/corr_lookup.cu``) and the SepConvGRU
direction (``csrc/gru_direction.cu``).
"""

__version__ = '0.1.0'
