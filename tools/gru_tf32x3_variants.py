#!/usr/bin/env python3
"""What moves the GRU direction kernel's error and time, on one GPU.

    python3 tools/gru_tf32x3_variants.py [--only NAME ...]

Builds ``video_features_torch/csrc/gru_direction.cu`` as it is and in
variants made by textual patches of that source, each into its own
library under ``build/gru_tf32x3_variants/``, all built in parallel.

3xTF32 (``passes=3``, the ``gru_tf32x3<·, ·, 3>`` kernel):

- 'kernel': the source as it is;
- 'one_accumulator': all 480 products of a pixel summed in the tensor
  cores' accumulator, without the kernel's per-tap fp32 flush;
- 'fourth_product': the kernel plus the fourth 3xTF32 product, lo·lo,
  first in each K step.

One pass (``passes=1``, the ``gru_tf32_onepass`` kernel):

- 'one_pass': the source as it is;
- 'pr14_one_pass': ``passes=1`` routed back to ``gru_tf32x3<·, ·, 1>``,
  the one-pass design before the cluster kernel (the same-call yardstick);
- 'copies_only': the cluster kernel with its ``wgmma``s removed: every
  copy, barrier and fragment load, no product (the feed floor; its
  outputs are meaningless);
- 'products_only': the weights fetched once (the first ring's worth) and
  the first slices staged once (one per slice buffer), then products over
  them (the issue and product floor; outputs meaningless);
- 'no_epilogue_loads': the epilogue without its loads of term, h and z
  (what their round trips cost; outputs meaningless);
- one lever taken away or changed at a time: 'cluster1' (no multicast:
  each CTA fetches every tile), 'cluster4' (clusters of 4), 'ring3' (a
  3-deep ring), 'in_flight' (``wgmma.wait_group 1``: each tap's group
  left running while the next is queued), 'tap_flush' (the fp32 flush
  after every tap, as in 3xTF32, instead of every slice), 'act3' (three
  slice buffers: rows staged two slices ahead, a shallower ring where
  the rows are tall), 'serial_epilogue' (each channel pair's loads after
  the previous pair's stores).

'a+b' applies both variants' patches (``--only tap_flush+products_only``).

Each runs one GRU direction, both axes, on seeded inputs at the scales of
``chip_smoke.py`` (and with motion ×4) at the RAFT family's batch-8 grid
(8, 32, 43) and the fused I3D path's (128, 32, 43): max abs error
against the plain version in float64 and in float32 (cuDNN, TF32 off;
the one-pass variants against the plain version of the rounded
operands, with the mean), and the time per direction (CUDA events over
10 launches, the variants taken in turns: forward, then backward). Beside
each time: the bytes its blocks pull from L2 into shared memory per
direction (weights once per tile per cluster, hi and lo in 3xTF32; each
slice's staged rows with their halo) and that over the time in TB/s.
A patch whose anchor is missing from the source fails the run
(``tests/test_torch_gru_variants.py`` checks the anchors on the CPU).
"""
from __future__ import annotations

import argparse
import ctypes
import math
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
    'one_pass': [],
    'pr14_one_pass': [
        ('if (passes == 1) return launch_one_pass(zr, q, stride, device, limit, s);',
         'if (passes == 1)\n'
         '    return wide ? launch<2, 1>(zr, q, device, limit, s)\n'
         '                : launch<1, 1>(zr, q, device, limit, s);'),
    ],
    'copies_only': [
        ('wgmma_m64n128k8(psum, f[kk], b_desc(b + kk * 32),\n'
         '                        kk > 0 || tap % kFlushTaps != 0);', ''),
    ],
    'products_only': [
        ('const int wsteps = kSteps, aslices = kSlices;',
         'const int wsteps = stages, aslices = kActBufs;'),
        ('mbar_wait_bounded(smem_addr(&full[s]), ph);',
         'mbar_wait_bounded(smem_addr(&full[s]), 0);'),
        ('mbar_wait_bounded(smem_addr(&afull[g % kActBufs]),\n'
         '                          (g / kActBufs) & 1);',
         'mbar_wait_bounded(smem_addr(&afull[g % kActBufs]), 0);'),
    ],
    'no_epilogue_loads': [
        ('t[r][j] = hv[r][j] = zv[r][j] = make_float2(0.f, 0.f);',
         't[r][j] = hv[r][j] = zv[r][j] = make_float2(0.f, 0.f);\n'
         '            continue;'),
    ],
    'cluster1': [('constexpr int kCluster = 2;', 'constexpr int kCluster = 1;')],
    'cluster4': [('constexpr int kCluster = 2;', 'constexpr int kCluster = 4;')],
    'ring3': [('constexpr int kRingMax = 8;', 'constexpr int kRingMax = 3;')],
    'in_flight': [('constexpr int kInFlight = 0;', 'constexpr int kInFlight = 1;')],
    'tap_flush': [('constexpr int kFlushTaps = 5;', 'constexpr int kFlushTaps = 1;')],
    'act3': [('constexpr int kActBufs = 2;', 'constexpr int kActBufs = 3;')],
    'serial_epilogue': [('constexpr int kEpilogueBatch = 8;',
                         'constexpr int kEpilogueBatch = 1;')],
}
THREE_PASS = ('kernel', 'one_accumulator', 'fourth_product')
# the variants whose outputs are not the direction's (timing only)
NO_RESULT = ('copies_only', 'products_only', 'no_epilogue_loads')
SHAPES = ((8, 32, 43), (128, 32, 43))
TILE_BYTES = 128 * 32 * 4       # one (slice, tap) tile part of 128 outputs
STEPS, SLICES = 40, 8
ACT_BUFS = 2                    # the cluster kernel's slice buffers (kActBufs)


def passes_of(name: str) -> int:
    return 3 if any(n in THREE_PASS for n in name.split('+')) else 1


def patches_of(name: str) -> list:
    """A variant's patches; 'a+b' applies a's, then b's."""
    return [pt for part in name.split('+') for pt in PATCHES[part]]


def patched_source(name: str) -> str:
    src = SRC.read_text()
    for anchor, new in patches_of(name):
        if src.count(anchor) != 1:
            raise SystemExit(f'{name}: anchor not once in {SRC.name}: {anchor!r}')
        src = src.replace(anchor, new)
    return src


def build(name: str):
    """The variant's library (ctypes, entry points typed) and ptxas's
    report."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f'{name}.cu', OUT / f'lib{name}.so'
    cu.write_text(patched_source(name))
    cuda = Path('/usr/local/cuda/bin/nvcc')
    nvcc = str(cuda) if cuda.exists() else 'nvcc'
    proc = subprocess.run(
        [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-o', str(lib),
         str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f'{name}: nvcc failed\n{proc.stderr}')
    dll = ctypes.CDLL(str(lib))
    dll.vft_gru_direction_passes.argtypes = ([ctypes.c_void_p] * 9
                                             + [ctypes.c_int] * 5
                                             + [ctypes.c_void_p])
    dll.vft_gru_direction_passes.restype = ctypes.c_int
    dll.vft_gru_one_pass_config.argtypes = ([ctypes.c_int] * 2
                                            + [ctypes.POINTER(ctypes.c_int)] * 5)
    dll.vft_gru_one_pass_config.restype = ctypes.c_int
    return dll, proc.stdout + proc.stderr


def one_pass_config(lib, width: int, axis: str) -> dict:
    """The cluster kernel's cluster size, ring stages, pixels per CTA,
    shared memory bytes per CTA and CTAs resident at once for a grid of
    this width."""
    vals = [ctypes.c_int() for _ in range(5)]
    rc = lib.vft_gru_one_pass_config(width, int(axis == 'h'),
                                     *[ctypes.byref(v) for v in vals])
    if rc:
        raise SystemExit(f'vft_gru_one_pass_config failed: CUDA error {rc}')
    return dict(zip(('cluster', 'stages', 'bm', 'smem', 'resident'),
                    (v.value for v in vals)))


def feed_bytes(shape, axis: str, cluster: int, bm: int, passes: int = 1,
               stages: int = 0) -> dict:
    """Bytes one direction's blocks pull from L2 into shared memory: the
    zr GEMM's two blocks along N and the q GEMM's one per M-tile (the
    tiles rounded up to whole clusters); per block the 40 weight tiles
    once per cluster (hi and lo in 3xTF32; ``stages`` tiles only, and
    ``ACT_BUFS`` slices, for 'products_only'), and each of the 8 slices' staged rows
    (the tile's pixels and the ±2-tap halo, 128 bytes each)."""
    b, h, w = shape
    m = b * h * w
    blocks = 3 * math.ceil(math.ceil(m / bm) / cluster) * cluster
    stride = w if axis == 'h' else 1
    rows = bm + 4 * min(stride, bm)
    tiles, slices = (stages, ACT_BUFS) if stages else (STEPS, SLICES)
    weights = blocks * tiles * TILE_BYTES * (2 if passes == 3 else 1) / cluster
    acts = blocks * slices * rows * 128
    return {'weights': weights, 'activations': acts, 'total': weights + acts}


def pr14_bm(width: int, axis: str) -> int:
    """gru_tf32x3's tile: 128 pixels where a slice's staged rows fit beside
    its 3 x 32 KB ring (W <= 83 on axis 'h'), else 64."""
    return 128 if axis == 'w' or width <= 83 else 64


def direction_call(lib, x, axis, passes, outs):
    """One direction through ``lib`` into the preallocated ``outs``
    (z, rh, out), on the current stream."""
    import torch
    h = x[0]
    B, H, W, _ = h.shape
    rc = lib.vft_gru_direction_passes(
        *[t.data_ptr() for t in x], *[t.data_ptr() for t in outs], B, H, W,
        int(axis == 'h'), passes, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise SystemExit(f'launch failed: CUDA error {rc}')
    return outs[2]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    parser.add_argument('--only', nargs='+',
                        help='build and run only these variants (a+b: both '
                             "variants' patches)")
    args = parser.parse_args()
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
    names = args.only or list(PATCHES)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build, names)))
    libs = {name: lib for name, (lib, _) in built.items()}
    for name, (_, log) in built.items():
        if passes_of(name) == 1:
            for line in log.splitlines():
                if any(k in line for k in ('registers', 'spill', 'wgmma', 'C7')):
                    print(f'  ptxas {name}: {line.strip()}')

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
            outs = tuple(torch.empty_like(x[0]) for _ in range(3))
            for axis in gru.AXES:
                refs = {}
                for p in sorted({passes_of(n) for n in names}):
                    refs[p] = (gru.gru_direction_plain(*[t.double() for t in x],
                                                       axis, passes=p),
                               gru.gru_direction_plain(*x, axis, passes=p))
                times = {n: [] for n in names}
                if motion_scale == 1.0:
                    for order in (names, names[::-1]):
                        for n in order:
                            p = passes_of(n)
                            times[n].append(cuda_ms(lambda: direction_call(
                                libs[n], x, axis, p, outs)))
                print(f'{shape} motion x{motion_scale:g} axis {axis}: fp32 '
                      f'plain vs float64 '
                      + ', '.join(f'{p}-pass {(refs[p][1] - refs[p][0]).abs().max().item():.3e}'
                                  for p in refs), flush=True)
                for n in names:
                    p = passes_of(n)
                    got = direction_call(libs[n], x, axis, p, outs)
                    torch.cuda.synchronize()
                    ref, plain = refs[p]
                    diff = (got - plain).abs()
                    line = (f'  {n} ({p}-pass): vs float64 '
                            f'{(got - ref).abs().max().item():.3e}, vs fp32 '
                            f'plain max {diff.max().item():.3e} mean '
                            f'{diff.mean().item():.3e}')
                    if set(n.split('+')) & set(NO_RESULT):
                        line += ' (timing only)'
                    if times[n]:
                        if p == 3 or 'pr14_one_pass' in n.split('+'):
                            cfg = {'cluster': 1, 'stages': 3, 'resident': 132,
                                   'bm': pr14_bm(shape[2], axis)}
                        else:
                            cfg = one_pass_config(libs[n], shape[2], axis)
                        fb = feed_bytes(shape, axis, cfg['cluster'], cfg['bm'], p,
                                        cfg['stages'] if 'products_only'
                                        in n.split('+') else 0)
                        ms = sum(times[n]) / len(times[n])
                        line += (f'; {times[n][0]:.4f} / {times[n][1]:.4f} ms '
                                 f'(cluster {cfg["cluster"]}, ring '
                                 f'{cfg["stages"]}, BM {cfg["bm"]}, '
                                 f'{cfg["resident"]} CTAs resident); L2 -> '
                                 f'SM {fb["weights"] / 1e9:.3f} GB weights + '
                                 f'{fb["activations"] / 1e9:.3f} GB rows = '
                                 f'{fb["total"] / 1e9:.3f} GB, '
                                 f'{fb["total"] / ms / 1e9:.2f} TB/s')
                    print(line, flush=True)
                del refs
            del x, outs
    return 0


if __name__ == '__main__':
    sys.exit(main())
