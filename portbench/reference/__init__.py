"""The plain references the benchmark holds the program to: RAFT and I3D
in plain PyTorch, channels-first, and the cv2 decode and PIL resize.
Nothing here imports the program.

A configuration's ``reference`` names one module here that exposes
``compare(cell, sample, weights, device) -> {number: value}`` (the
window's outputs against the plain pipeline) and ``flops(cell) ->
(FLOPs per item, {benchmark range: FLOPs per call})`` (the work counted
from the cell's shapes): ``i3d_raft`` and ``raft_flow``."""
