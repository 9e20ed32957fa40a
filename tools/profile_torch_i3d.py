#!/usr/bin/env python3
"""Where the time goes in the port's fused I3D two-stream step, on one GPU.

    python3 tools/profile_torch_i3d.py [--batch 8] [--iters 20] [--steps 3]
        [--precision highest]

Runs ``video_features_torch``'s ``ExtractI3D.step`` (both streams, stack
16, RAFT at 20 iterations, the config's batch 8) on seeded 256×340 uint8
frames with random weights, under ``--precision`` (printed on the first
line). After one warm-up step it times ``--steps`` steps with CUDA
events, times each part of the step (rgb tower, RAFT + quantization,
flow tower) the same way inside the extractor's precision scope, then
traces one step with ``torch.profiler`` and prints the device time per
kernel group (the correlation lookup kernels, the GRU direction kernel,
the 3xTF32 convolution, matrix products, convolutions, the rest),
the top kernels, and the share of the step's wall time in which the
device was busy (the union of kernel intervals). The last line is
one JSON object with the same numbers.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

GROUPS = (('corr_lookup', ('masked_kernel', 'padded_kernel')),
          ('gru_direction', ('gru_tf32x3', 'gru_tf32_onepass')),
          # the hand kernels before 'gemm' and 'conv', which would take
          # any name with 'gemm' or 'conv' in it
          ('conv_tf32x3', ('conv_tf32x3',)),
          ('gemm_tf32x3', ('gemm_tf32x3',)),
          ('dwconv_f32', ('dwconv_f32',)),
          ('gemm', ('gemm', 'cutlass', 'sm90_xmma', 'cublas')),
          ('conv', ('conv', 'cudnn', 'implicit', 'winograd', 'fft')),
          ('pool', ('pool',)))


def group_of(name: str) -> str:
    low = name.lower()
    for group, keys in GROUPS:
        if any(k in low for k in keys):
            return group
    return 'other'


def union_ms(spans) -> float:
    """Length of the union of (start_us, end_us) intervals, in ms."""
    total, end = 0.0, None
    for s, e in sorted(spans):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def event_ms(torch, fn, reps: int) -> float:
    """CUDA-event ms per call of ``fn`` over ``reps`` calls, after one."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def layer_ms(torch, ex, stacks, reps: int, timer=event_ms) -> dict:
    """Time per step of each part of the fused step (``timer``, CUDA
    events by default): the rgb tower, the flow stream's input (RAFT +
    quantization), the flow tower, each in the extractor's precision
    scope and with its lane's kernels, as ``ex.step`` runs them."""
    from video_features_torch.extract.i3d import (
        CROP_SIZE, flow_stream_input, rgb_stream_input,
    )
    from video_features_torch.models import i3d
    from video_features_torch.models.raft import pad_amounts
    x = torch.from_numpy(stacks).to(ex.device)
    pads = pad_amounts(*stacks.shape[2:4])
    lane = dict(three_pass_convs=ex.three_pass_convs)
    raft_lane = dict(lane, raft_iters=ex.raft_iters, gru_passes=ex.gru_passes)
    with torch.inference_mode(), ex.precision_scope():
        flow_in = flow_stream_input(ex.params['raft'], x, pads, CROP_SIZE,
                                    **raft_lane)
        parts = {
            'i3d_rgb': lambda: i3d.forward(
                ex.params['rgb'], rgb_stream_input(x, CROP_SIZE), **lane),
            'raft_flow_input': lambda: flow_stream_input(
                ex.params['raft'], x, pads, CROP_SIZE, **raft_lane),
            'i3d_flow': lambda: i3d.forward(ex.params['flow'], flow_in,
                                            **lane),
        }
        return {name: timer(torch, fn, reps) for name, fn in parts.items()}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--batch', type=int, default=8)
    ap.add_argument('--iters', type=int, default=20)
    ap.add_argument('--steps', type=int, default=3)
    ap.add_argument('--precision', default='highest',
                    help="the extractor's precision lane (default highest)")
    a = ap.parse_args()

    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print('profile_torch_i3d: needs a CUDA device', file=sys.stderr)
        return 1
    from video_features_torch.extract.i3d import ExtractI3D

    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f'precision={a.precision} ({smi})')
    ex = ExtractI3D({
        'feature_type': 'i3d', 'stack_size': 16, 'step_size': 16,
        'raft_iters': a.iters, 'batch_size': a.batch, 'device': 'cuda',
        'allow_random_weights': True, 'on_extraction': 'print',
        'output_path': str(ROOT / 'output'), 'concat_rgb_flow': True,
        'precision': a.precision})
    rng = np.random.RandomState(0)
    stacks = rng.randint(0, 256, (a.batch, 17, 256, 340, 3)).astype(np.uint8)

    ex.step(stacks)                                  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(a.steps):
        ex.step(stacks)
    end.record()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / a.steps
    event_ms = start.elapsed_time(end) / a.steps

    layers = layer_ms(torch, ex, stacks, a.steps)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        ex.step(stacks)
        torch.cuda.synchronize()
        traced_wall_ms = (time.perf_counter() - t1) * 1e3
    by_name = defaultdict(float)
    spans = []
    for ev in prof.events():
        if not str(getattr(ev, 'device_type', '')).endswith('CUDA'):
            continue                    # host-side ops; their kernels are events of their own
        start_us, end_us = ev.time_range.start, ev.time_range.end
        by_name[ev.name] += (end_us - start_us) / 1e3
        spans.append((start_us, end_us))
    busy_ms = union_ms(spans)
    device_ms = sum(by_name.values())
    groups = defaultdict(float)
    for name, ms in by_name.items():
        groups[group_of(name)] += ms

    print(f'batch {a.batch}, RAFT {a.iters} iterations: step {event_ms:.1f} ms '
          f'(CUDA events), {wall_ms:.1f} ms wall, '
          f'{event_ms / a.batch:.2f} ms per window')
    print('layers (CUDA events, ms per step): '
          + ', '.join(f'{k} {v:.1f}' for k, v in layers.items()))
    print(f'traced step: kernels {device_ms:.1f} ms, device busy {busy_ms:.1f} '
          f'ms of {traced_wall_ms:.1f} ms wall ({busy_ms / traced_wall_ms:.1%})')
    for group, ms in sorted(groups.items(), key=lambda kv: -kv[1]):
        print(f'  {group:12s} {ms:9.2f} ms  {ms / max(device_ms, 1e-9):6.1%}')
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:12]
    for name, ms in top:
        print(f'  {ms:9.2f} ms  {name[:100]}')
    print(json.dumps({
        'device': smi, 'precision': a.precision, 'batch': a.batch,
        'raft_iters': a.iters,
        'step_ms': event_ms, 'step_wall_ms': wall_ms,
        'window_ms': event_ms / a.batch, 'layers_ms': layers,
        'traced_wall_ms': traced_wall_ms, 'traced_kernel_ms': device_ms,
        'device_busy_ms': busy_ms,
        'device_busy': busy_ms / traced_wall_ms if traced_wall_ms else None,
        'groups_ms': dict(groups),
        'top_kernels_ms': {n[:100]: ms for n, ms in top}}))
    return 0


if __name__ == '__main__':
    sys.exit(main())
