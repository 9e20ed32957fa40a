#!/usr/bin/env python3
"""How the GRU kernel's 3xTF32 accumulation choices move its error and time,
on one GPU.

    python3 tools/gru_tf32x3_variants.py

Builds ``video_features_torch/csrc/gru_direction.cu`` as it is ('kernel')
and in variants made by textual patches of that source, each into its own
library under ``build/gru_tf32x3_variants/``:

- 'one_accumulator': all 480 products of a pixel summed in the tensor
  cores' accumulator, without the kernel's per-tap fp32 flush;
- 'fourth_product': the kernel plus the fourth 3xTF32 product, lo·lo,
  first in each K step.

Each runs one GRU direction, both axes, on seeded inputs at the scales of
``chip_smoke.py`` (and with motion ×4) at the RAFT family's batch-8 grid
(8, 32, 43) and the fused I3D path's (128, 32, 43): max abs error against
the plain version in float64 and in float32 (cuDNN, TF32 off), and the
time per direction (CUDA events over 10 launches). A patch whose anchor
is missing from the source fails the run.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = ROOT / 'video_features_torch' / 'csrc' / 'gru_direction.cu'
OUT = ROOT / 'build' / 'gru_tf32x3_variants'
# (anchor, replacement) pairs per variant, applied to the kernel's source
PATCHES = {
    'kernel': [],
    'one_accumulator': [
        ('float acc[64], part[64];', 'float acc[64]; float (&part)[64] = acc;'),
        ('wgmma_m64n128k8(part, lo, dhi, k > 0);', 'wgmma_m64n128k8(part, lo, dhi, 1);'),
        ('for (int i = 0; i < 64; ++i) acc[i] += part[i];', ''),
    ],
    'fourth_product': [
        ('wgmma_m64n128k8(part, lo, dhi, k > 0);',
         'wgmma_m64n128k8(part, lo, b_desc(bhi + kTileBytes + k * 32), k > 0);\n'
         '        wgmma_m64n128k8(part, lo, dhi, 1);'),
    ],
}
SHAPES = ((8, 32, 43), (128, 32, 43))


def build(name: str) -> ctypes.CDLL:
    src = SRC.read_text()
    for anchor, new in PATCHES[name]:
        if anchor not in src:
            raise SystemExit(f'{name}: anchor not in {SRC.name}: {anchor!r}')
        src = src.replace(anchor, new)
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f'{name}.cu', OUT / f'lib{name}.so'
    cu.write_text(src)
    cuda = Path('/usr/local/cuda/bin/nvcc')
    nvcc = str(cuda) if cuda.exists() else 'nvcc'
    proc = subprocess.run(
        [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-o', str(lib), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f'{name}: nvcc failed\n{proc.stderr}')
    dll = ctypes.CDLL(str(lib))
    dll.vft_gru_direction.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
                                      + [ctypes.c_void_p])
    dll.vft_gru_direction.restype = ctypes.c_int
    return dll


def main() -> int:
    sys.path.insert(0, str(ROOT))
    import torch
    if not torch.cuda.is_available():
        print('gru_tf32x3_variants: needs a CUDA device', file=sys.stderr)
        return 1
    from video_features_torch.ops import gru
    from video_features_torch.utils.device import set_precision
    set_precision('highest')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True).stdout.strip())
    with ThreadPoolExecutor(len(PATCHES)) as pool:
        libs = dict(zip(PATCHES, pool.map(build, PATCHES)))

    def run(lib, x, axis):
        h = x[0]
        z, rh, out = (torch.empty_like(h) for _ in range(3))
        B, H, W, _ = h.shape
        rc = lib.vft_gru_direction(*[t.data_ptr() for t in x], z.data_ptr(),
                                   rh.data_ptr(), out.data_ptr(), B, H, W,
                                   int(axis == 'h'),
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise SystemExit(f'launch failed: CUDA error {rc}')
        return out

    def cuda_ms(fn, reps=10):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / reps

    gen = torch.Generator(device='cuda').manual_seed(1)
    for shape in SHAPES:
        for motion_scale in (1.0, 4.0):
            def randn(*s):
                return torch.randn(*s, device='cuda', generator=gen)
            x = (torch.tanh(randn(*shape, 128)), motion_scale * randn(*shape, 128),
                 *gru.pack_direction(0.05 * randn(256, 256, 1, 5),
                                     0.05 * randn(128, 256, 1, 5)),
                 0.1 * randn(*shape, 256), 0.1 * randn(*shape, 128))
            for axis in gru.AXES:
                ref = gru.gru_direction_plain(*[t.double() for t in x], axis)
                plain = gru.gru_direction_plain(*x, axis)
                line = (f'{shape} motion x{motion_scale:g} axis {axis}: fp32 plain '
                        f'vs float64 {(plain - ref).abs().max().item():.3e}')
                for name, lib in libs.items():
                    got = run(lib, x, axis)
                    torch.cuda.synchronize()
                    line += (f' | {name}: vs float64 '
                             f'{(got - ref).abs().max().item():.3e}, vs fp32 '
                             f'plain {(got - plain).abs().max().item():.3e}')
                    if motion_scale == 1.0:
                        line += f', {cuda_ms(lambda: run(lib, x, axis)):.4f} ms'
                print(line, flush=True)
            del x
    return 0


if __name__ == '__main__':
    sys.exit(main())
