"""PyTorch/CUDA port of video_features_tpu (NVIDIA Hopper).

The package mirrors the module layout of ``video_features_tpu`` and keeps
its channels-last layouts at every public function, so the two can be
compared tensor for tensor. It imports ``torch`` and never ``jax``, and
nothing of ``video_features_tpu``: what it needs from that package's
jax-free modules is copied here.

Ported so far: the fused I3D two-stream path (RAFT flow + both I3D
towers) behind ``python -m video_features_torch feature_type=i3d``, with
RAFT's correlation-window lookup in hand-written CUDA kernels
(``csrc/corr_lookup.cu``).
"""
