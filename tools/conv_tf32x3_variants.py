#!/usr/bin/env python3
"""What holds the 3xTF32 convolution back, on one GPU.

    python3 tools/conv_tf32x3_variants.py [--only NAME ...]

Builds ``video_features_torch/csrc/conv_tf32x3.cu`` as it is and in
variants made by textual patches of that source, each into its own
library under ``build/conv_tf32x3_variants/``, all built in parallel:

- 'kernel': the source as it is;
- 'copies_only': its ``wgmma``s removed: every copy, barrier, fragment
  load, split and flush, no product (the feed floor);
- 'products_only': no copy at all (no weight tile, no rows): products
  over whatever the stages hold (the product floor);
- 'no_a_copies': the weight tiles fetched, the rows not (what staging the
  implicit-GEMM rows costs);
- 'no_w_copies': the rows staged, the weight tiles not;
- 'no_flush': no fp32 add of each chunk's products to the running sum;
- 'lockstep': rows staged into the stage chunk q - 1 frees (so each warp
  waits at every chunk for the other warpgroup's last one) instead of
  q - 2.

Outputs of every variant but 'kernel' are meaningless. 'a+b' applies
both variants' patches (``--only products_only+no_flush``).

Each runs the convolutions of :data:`CASES` on seeded inputs (RAFT's
seven per-iteration convolutions at the fused I3D path's batch-8 size,
M = 176,128, and at the RAFT family's 8 pairs, M = 10,752; the three
heaviest I3D convolutions at batch 8), the variants taken in turns
(forward, then backward), CUDA events over 5 launches each, with the
weights packed ahead; 'kernel' is held to the plain version (cuDNN in
fp32). Beside each time: the bytes its blocks pull from L2 into shared
memory (each block's weight tiles, hi and lo, and its rows, 128 bytes per
row per chunk) and that over the time in TB/s. A patch whose anchor is
not in the source once fails the run
(``tests/test_torch_conv_variants.py`` checks the anchors on the CPU).
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
SRC = ROOT / 'video_features_torch' / 'csrc' / 'conv_tf32x3.cu'
OUT = ROOT / 'build' / 'conv_tf32x3_variants'

_PRODUCTS = ('      wgmma_tf32<BN>(part, lo[k], b_desc(bhi + 32 * k), k > 0);'
             '    // afresh\n'
             '      wgmma_tf32<BN>(part, hi[k], b_desc(blo + 32 * k), 1);\n'
             '      wgmma_tf32<BN>(part, hi[k], b_desc(bhi + 32 * k), 1);\n')
_WEIGHTS = ('    if (tid == 0)\n'
            '      bulk_load(wstage + s * T::kWBytes, wsrc + (size_t)q * '
            '(T::kWBytes / 4),\n'
            '                T::kWBytes, bar);\n')
_NO_WEIGHTS = ('    if (tid == 0) asm volatile("mbarrier.arrive.shared::cta.b64 '
               '_, [%0];\\n" :: "r"(bar) : "memory");\n')
_ROWS = ('      cp_async16(dst + i * (T::kThreads / 8) * kLda * 4,\n'
         '                 g.x + (ok ? rw.x + off : 0), ok);\n')
# (anchor, replacement) pairs per variant, applied to the kernel's source
PATCHES = {
    'kernel': [],
    'copies_only': [(_PRODUCTS, '')],
    'products_only': [(_WEIGHTS, _NO_WEIGHTS), (_ROWS, '')],
    'no_a_copies': [(_ROWS, '')],
    'no_w_copies': [(_WEIGHTS, _NO_WEIGHTS)],
    'no_flush': [('    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];\n',
                  '')],
    'lockstep': [('const int ahead = g.stages > 2 ? g.stages - 2 : 1;',
                  'const int ahead = g.stages - 1;')],
}

# (name, x shape, weight shape, stride, padding)
FUSED, FAMILY = (128, 32, 43), (8, 32, 42)
SEVEN = (('convc1', 324, 256, (1, 1), 0), ('convc2', 256, 192, (3, 3), 1),
         ('convf1', 2, 128, (7, 7), 3), ('convf2', 128, 64, (3, 3), 1),
         ('conv', 256, 126, (3, 3), 1), ('flow_head.conv1', 128, 256, (3, 3), 1),
         ('flow_head.conv2', 256, 2, (3, 3), 1))
CASES = tuple((f'{where} {name}', (*pix, c), (o, c, *k), 1, pad)
              for where, pix in (('fused', FUSED), ('family', FAMILY))
              for name, c, o, k, pad in SEVEN) + (
    ('i3d rgb conv1', (8, 16, 224, 224, 3), (64, 3, 7, 7, 7), 2, [(2, 3)] * 3),
    ('i3d flow conv1', (8, 16, 224, 224, 2), (64, 2, 7, 7, 7), 2, [(2, 3)] * 3),
    ('i3d 3x3x3 64->192', (8, 8, 56, 56, 64), (192, 64, 3, 3, 3), 1,
     [(1, 1)] * 3))


def patches_of(name: str):
    return [pt for part in name.split('+') for pt in PATCHES[part]]


def patched_source(name: str) -> str:
    src = SRC.read_text()
    for anchor, new in patches_of(name):
        if src.count(anchor) != 1:
            raise SystemExit(f'{name}: anchor not once in {SRC.name}: {anchor!r}')
        src = src.replace(anchor, new)
    return src


def build(name: str):
    """The variant's library (ctypes, its entry point typed)."""
    OUT.mkdir(parents=True, exist_ok=True)
    cu, lib = OUT / f'{name}.cu', OUT / f'lib{name}.so'
    cu.write_text(patched_source(name))
    cuda = Path('/usr/local/cuda/bin/nvcc')
    nvcc = str(cuda) if cuda.exists() else 'nvcc'
    proc = subprocess.run(
        [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-o', str(lib), str(cu)],
        capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f'{name}: nvcc failed\n{proc.stderr}')
    dll = ctypes.CDLL(str(lib))
    dll.vft_conv_tf32x3.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 25
                                    + [ctypes.c_void_p])
    dll.vft_conv_tf32x3.restype = ctypes.c_int
    return dll


def feed_bytes(m: int, weight_shape, bm: int) -> dict:
    """Bytes one call's blocks pull from L2 into shared memory: per block
    (``bm`` pixels of one output tile) every K chunk's weight tile, hi
    and lo, and its rows, 128 bytes each."""
    from video_features_torch.ops import conv_tf32x3 as k
    tiles, chunks, _, bn, _ = k.packed_shape(weight_shape)
    blocks = math.ceil(m / bm) * tiles
    weights = blocks * chunks * 2 * bn * k.K_CHUNK * 4
    rows = blocks * chunks * bm * k.K_CHUNK * 4
    return {'weights': weights, 'rows': rows, 'total': weights + rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--only', nargs='*', default=None,
                    help='variants (default: all), "a+b" for both patches')
    args = ap.parse_args(argv)
    names = args.only or list(PATCHES)
    sys.path.insert(0, str(ROOT))
    import torch
    from video_features_torch.ops import conv_tf32x3 as k
    from video_features_torch.utils.device import set_precision
    set_precision('highest')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names)))
    gen = torch.Generator(device='cuda').manual_seed(5)

    def ms(fn, reps=5):
        fn()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / reps

    for name, xs, ws, stride, pad in CASES:
        x = torch.randn(*xs, device='cuda', generator=gen)
        w = torch.randn(*ws, device='cuda', generator=gen) * 0.05
        want = k.conv_tf32x3_plain(x, w, stride, pad)
        packed = k.pack_weight(w)
        c4 = -(-xs[-1] // k.C_GROUP) * k.C_GROUP
        x4 = torch.nn.functional.pad(x, (0, c4 - xs[-1]))
        n = len(ws) - 2
        pads = [p for pair in k._pad_pairs(pad, n) for p in pair]
        out, (t, h, wd), geo = k._geometry(x4, w, list(k._tuple(stride, n)), pads)
        m = xs[0] * math.prod(out)
        plan = k.conv_plan(m, ws[0], torch.cuda.get_device_properties(0)
                           .multi_processor_count)
        y = torch.empty_like(want)

        def call(lib):
            rc = lib.vft_conv_tf32x3(
                x4.data_ptr(), packed.data_ptr(), None, y.data_ptr(), xs[0], t,
                h, wd, c4, *geo, c4, c4, ws[0], plan.bm, plan.bn, plan.tiles,
                packed.shape[1], torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f'{name}: launch failed, CUDA error {rc}')
        times = {v: [] for v in names}
        for v in names + names[::-1]:
            times[v].append(ms(lambda: call(libs[v])))
        line = []
        feed = feed_bytes(m, ws, plan.bm)
        for v in names:
            t_ms = sum(times[v]) / len(times[v])
            line.append(f'{v} {t_ms:.4f} ms ({feed["total"] / t_ms / 1e9:.2f} TB/s)')
        rel = ''
        if 'kernel' in libs:
            call(libs['kernel'])
            rel = f'kernel rel L2 {((y - want).norm() / want.norm()).item():.2e}; '
        bound = 3 * 2 * m * ws[0] * math.prod(ws[1:]) / 495e12 * 1e3
        print(f'{name} (M {m}, plan {tuple(plan)}; {rel}3xTF32 bound '
              f'{bound:.4f} ms; L2 -> SM {feed["weights"] / 1e9:.3f} GB weights '
              f'+ {feed["rows"] / 1e9:.3f} GB rows): {", ".join(line)} ({card})',
              flush=True)
        del x, w, want, packed, x4, y
        torch.cuda.empty_cache()
    return 0


if __name__ == '__main__':
    sys.exit(main())
