"""Subprocess entry point for the native constant-frame-rate re-encode.

``python video_features_torch/io/reencode_cli.py <in> <out> <fps>`` loads
``libvfdecode`` through the port's binding, runs one ``vf_reencode_fps``
call and exits.

It runs in a process of its own because libx264's rate control can take
different decisions depending on what the host process has run before,
while a fresh process always encodes the same input to the same bytes,
as the ffmpeg CLI does.
"""
from __future__ import annotations

import sys


def main(argv) -> int:
    if len(argv) != 3:
        print('usage: reencode_cli <in> <out> <fps>', file=sys.stderr)
        return 2
    in_path, out_path, fps = argv[0], argv[1], float(argv[2])
    from video_features_torch.io.native import load_library

    lib = load_library()
    if lib is None:
        print('native library unavailable', file=sys.stderr)
        return 3
    ret = lib.vf_reencode_fps(str(in_path).encode(), str(out_path).encode(), fps)
    if ret != 0:
        print(lib.vf_last_error().decode(errors='replace'), file=sys.stderr)
        return 1
    return 0


if __name__ == '__main__':
    raise SystemExit(main(sys.argv[1:]))
