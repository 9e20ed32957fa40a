#!/usr/bin/env python3
"""The fused I3D path's per-video and packed loops over clips on disk, on
one GPU, for one tree of the port.

    python3 tools/loop_bench.py [--tree DIR] [--corpus mixed|long]
                                [--reps 3] [--iters 20]

Imports ``video_features_torch`` from ``--tree`` (default: this
checkout; a ``git archive`` of another commit unpacked under ``tmp/``
compares two commits in one call: run parent, change, change, parent).
Writes seeded MJPG clips with cv2: ``mixed``, four clips (256×340 of 49
and 33 frames, 240×320 of 81 and 17: 3, 2, 5 and 1 windows of 17 at
step 16, one step each per video); ``long``, one 240×320 clip of 337
frames (21 windows, 3 steps, each frame resized on the host). Builds
the i3d extractor through ``load_config`` and ``create_extractor`` at
full width (both towers, RAFT ``--iters`` iterations, batch 8, random
weights), runs one warm-up pass, then ``--reps`` timed passes of each
loop the tree has: the per-video loop (``_extract`` per clip) at
``decode_workers`` 1 and ``inflight`` 1, and where the tree supports
them at ``decode_workers`` 2 and ``inflight`` 2, and the packed loop
(``extract_packed``). Each pass writes a fresh output tree and ends in
``torch.cuda.synchronize()``. Prints the card's name and power limit,
then one JSON object with every pass's seconds.
"""
from __future__ import annotations

import argparse
import json
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CORPORA = {'mixed': ((49, 256, 340), (33, 256, 340), (81, 240, 320),
                     (17, 240, 320)),
           'long': ((337, 240, 320),)}
FPS = 25.0


def write_clips(np, root: Path, clips) -> list:
    import cv2
    rng = np.random.RandomState(40)
    paths = []
    for i, (n, h, w) in enumerate(clips):
        path = root / f'clip{i}.avi'
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*'MJPG'),
                                 FPS, (w, h))
        if not writer.isOpened():
            raise SystemExit(f'cv2 cannot write {path}')
        for _ in range(n):
            writer.write(rng.randint(0, 256, (h, w, 3)).astype(np.uint8))
        writer.release()
        paths.append(str(path))
    return paths


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument('--tree', default=str(ROOT))
    parser.add_argument('--corpus', choices=tuple(CORPORA), default='mixed')
    parser.add_argument('--reps', type=int, default=3)
    parser.add_argument('--iters', type=int, default=20)
    a = parser.parse_args()
    tree = Path(a.tree).resolve()
    sys.path.insert(0, str(tree))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('no CUDA device')
    from video_features_torch.config import load_config
    from video_features_torch.registry import create_extractor
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    root = tree / 'output' / 'loop_bench'
    shutil.rmtree(root, ignore_errors=True)
    root.mkdir(parents=True)
    clips = CORPORA[a.corpus]
    paths = write_clips(np, root, clips)
    ex = create_extractor(load_config('i3d', overrides={
        'video_paths': paths, 'device': 'cuda', 'streams': None,
        'stack_size': 16, 'step_size': 16, 'raft_iters': a.iters,
        'batch_size': 8, 'allow_random_weights': True, 'decode_workers': 1,
        'on_extraction': 'save_numpy', 'output_path': str(root / 'cfg'),
        'tmp_path': str(root / 'tmp')}))
    pipelined = hasattr(ex, 'extract_packed')
    runs = 0

    def per_video(workers: int, inflight: int):
        def run():
            if pipelined:
                ex.decode_workers, ex.inflight = workers, inflight
            ex.output_path = str(root / f'run{runs}')
            for p in paths:
                ex._extract(p)
        return run

    def packed():
        from video_features_torch.parallel.packing import VideoTask
        ex.decode_workers = 1
        ex.extract_packed([VideoTask(p, out_root=str(root / f'run{runs}'))
                           for p in paths], inflight=2)

    loops = {'per_video_w1_i1': per_video(1, 1)}
    if pipelined:
        loops.update(per_video_w2_i2=per_video(2, 2), packed_w1_i2=packed)
    result = {'tree': str(tree), 'device': torch.cuda.get_device_name(0),
              'power': smi, 'iters': a.iters, 'batch': 8, 'corpus': a.corpus,
              'windows': sum((n - 17) // 16 + 1 for n, _, _ in clips),
              'seconds': {}}
    for name, run in loops.items():
        run()                                    # warm-up
        runs += 1
        times = []
        for _ in range(a.reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t0)
            runs += 1
        result['seconds'][name] = times
        print(f'{name}: ' + ', '.join(f'{t:.3f}' for t in times) + ' s',
              flush=True)
    shutil.rmtree(root, ignore_errors=True)
    print(json.dumps(result))
    return 0


if __name__ == '__main__':
    sys.exit(main())
