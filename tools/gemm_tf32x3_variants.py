#!/usr/bin/env python3
"""What holds the 3xTF32 GEMM back, on one GPU.

    python3 tools/gemm_tf32x3_variants.py [--design ws|lockstep]
        [--only NAME ...] [--host]

Builds the kernel's source (``--design ws``, the default:
``video_features_torch/csrc/gemm_tf32x3.cu``; ``--design lockstep``: its
earlier design, ``csrc/gemm_tf32x3_lockstep.cu``) as it is and in
variants made by textual patches of that source, each into its own
library under ``build/gemm_tf32x3_variants/``, all built in parallel:

- 'kernel': the source as it is;
- 'copies_only': its ``wgmma``s removed: every copy, barrier, fragment
  load, split and flush, no product (the feed floor);
- 'products_only': no copy into shared memory at all: products over
  whatever the stages hold (the product floor, with the splits);
- 'no_split': B's tile not split into hi and lo by the consumers (what
  the split costs; the warp-specialised kernel splits only activations,
  a weight comes pre-split);
- 'no_flush': no fp32 add of each chunk's products to the running sum.

Outputs of every variant but 'kernel' are meaningless. 'a+b' applies
both variants' patches (``--only products_only+no_split``).

Each runs the GEMMs of :data:`CASES` on seeded inputs (ViT-B/16's
batch-32 step: its four linears at M = 6304 and its two attention
products over 384 heads on the head views in place), the variants taken
in turns (forward, then backward), each from a CUDA graph of 10 calls
replayed 3 times (``--yardstick`` adds the lockstep design as a column);
'kernel' is held to the plain version (``torch.matmul`` in fp32). Beside
each time: the share of the 3xTF32 bound (operations at the tensor
cores' 495 TFLOP/s, or bytes at 3.35 TB/s, the larger). A patch whose
anchor is not in the source once fails the run
(``tests/test_torch_gemm_variants.py`` checks the anchors on the CPU).

``--host`` also prints the wrapper's host µs per launch over CLIP
ViT-B/32's batch-8 step (:func:`host_us_per_launch`).
"""
from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / 'video_features_torch' / 'csrc'
SRC = CSRC / 'gemm_tf32x3.cu'
OUT = ROOT / 'build' / 'gemm_tf32x3_variants'

# the warp-specialised kernel (csrc/gemm_tf32x3.cu)
_PRODUCTS = ('        wgmma_tf32<BN>(part, lo[k], b_desc(bhi + 32 * k), k > 0);'
             '   // a fresh sum\n'
             '        wgmma_tf32<BN>(part, hi[k], b_desc(blo + 32 * k), 1);\n'
             '        wgmma_tf32<BN>(part, hi[k], b_desc(bhi + 32 * k), 1);\n')
_COPY16 = ('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"\n'
           '               :: "r"(dst), "l"(src), "r"(bytes) : "memory");\n')
_EXPECT = ('      mbar_expect(bar, (g.a_tma ? BM * kBK * 4 : 0) + '
           '(PACKED ? T::kTile : 0));\n')
_BULK = ('        bulk_load(sb, bbase + (size_t)c * (T::kTile / 4), '
         'T::kTile, bar);\n')
_TMA = '      if (g.a_tma) tma_load(sa, &amap, k0, m0, z2, z1, bar);\n'
_SPLIT_NK = ('            split(rb[n * kRowF + o + kk], h, l);\n'
             '            const int pos = split_pos(n, kk);\n'
             '            phi[pos] = h;\n'
             '            plo[pos] = l;\n')
_SPLIT_KN = ('            split(rb[kk * (BN + 4) + o + n], h, l);\n'
             '            const int pos = split_pos(n, kk);\n'
             '            phi[pos] = h;\n'
             '            plo[pos] = l;\n')
_FLUSH = '      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];\n'
# (anchor, replacement) pairs per variant, applied to the kernel's source
PATCHES = {
    'kernel': [],
    'copies_only': [(_PRODUCTS, '')],
    'products_only': [(_EXPECT, '      mbar_expect(bar, 0);\n'),
                      (_BULK, '        ;\n'), (_TMA, ''), (_COPY16, '')],
    # the activations' split (a weight is split once, before the kernel)
    'no_split': [(_SPLIT_NK, ''), (_SPLIT_KN, '')],
    'no_flush': [(_FLUSH, '')],
}

# the lockstep yardstick (csrc/gemm_tf32x3_lockstep.cu)
_L_PRODUCTS = ('      wgmma_tf32<BN>(part, lo[k], b_desc(bhi + 32 * k), k > 0);'
               '    // afresh\n'
               '      wgmma_tf32<BN>(part, hi[k], b_desc(blo + 32 * k), 1);\n'
               '      wgmma_tf32<BN>(part, hi[k], b_desc(bhi + 32 * k), 1);\n')
_L_CP16 = ('  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n"\n'
           '               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");\n')
_L_CP4 = ('  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\\n"\n'
          '               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");\n')
_L_SPLIT = ('        const int pos = split_pos(n, kk);\n'
            '        phi[pos] = h;\n'
            '        plo[pos] = l;\n'
            '      }\n'
            '    } else {\n')
_L_SPLIT_KN = ('        const int pos = split_pos(n, kk);\n'
               '        phi[pos] = h;\n'
               '        plo[pos] = l;\n'
               '      }\n'
               '    }\n'
               '    // the split tile')
LOCKSTEP_PATCHES = {
    'kernel': [],
    'copies_only': [(_L_PRODUCTS, '')],
    'products_only': [(_L_CP16, ''), (_L_CP4, '')],
    'no_split': [(_L_SPLIT, '      }\n    } else {\n'),
                 (_L_SPLIT_KN, '      }\n    }\n    // the split tile')],
    'no_flush': [('    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];\n',
                  '')],
}

# design -> (source, its patches, the wrapper that launches it, the name of
# the wrapper module's library loader the variants stand in for)
DESIGNS = {
    'ws': (SRC, PATCHES, 'gemm_tf32x3', '_library'),
    'lockstep': (CSRC / 'gemm_tf32x3_lockstep.cu', LOCKSTEP_PATCHES,
                 'gemm_tf32x3_lockstep', '_lockstep_library'),
}


def patches_of(name: str, design: str = 'ws'):
    table = DESIGNS[design][1]
    return [pt for part in name.split('+') for pt in table[part]]


def patched_source(name: str, design: str = 'ws') -> str:
    src_path = DESIGNS[design][0]
    src = src_path.read_text()
    for anchor, new in patches_of(name, design):
        if src.count(anchor) != 1:
            raise SystemExit(f'{name}: anchor not once in {src_path.name}: '
                             f'{anchor!r}')
        src = src.replace(anchor, new)
    return src


def build(name: str, design: str = 'ws'):
    """The variant's library, as ``ops/gemm_tf32x3.py::typed_library``
    types it."""
    from video_features_torch.ops import gemm_tf32x3 as g
    OUT.mkdir(parents=True, exist_ok=True)
    stem = f'{design}_{name}'
    cu, lib = OUT / f'{stem}.cu', OUT / f'lib{stem}.so'
    cu.write_text(patched_source(name, design))
    cuda = Path('/usr/local/cuda/bin/nvcc')
    nvcc = str(cuda) if cuda.exists() else 'nvcc'
    proc = subprocess.run(
        [nvcc, '-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
         '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v', '-o', str(lib),
         str(cu)], capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f'{stem}: nvcc failed\n{proc.stderr}')
    if name == 'kernel':
        for line in proc.stderr.splitlines():
            if ('registers' in line or 'spill' in line or 'Performance' in line
                    or 'setmaxnreg' in line):
                print(f'  ptxas {stem}: {line.strip()}', flush=True)
    return g.typed_library(ctypes.CDLL(str(lib)))


# ViT-B/16 at batch 32: 197 tokens, width 768, 12 heads of 64, MLP 3072
BATCH, TOKENS, WIDTH, HEADS, MLP = 32, 197, 768, 12, 3072
# (name, (K, N) of a linear) or (name, product)
LINEARS = (('qkv 768->2304', WIDTH, 3 * WIDTH), ('proj 768->768', WIDTH, WIDTH),
           ('fc1 768->3072', WIDTH, MLP), ('fc2 3072->768', MLP, WIDTH))
CASES = tuple(name for name, _, _ in LINEARS) + ('QK^T', 'PV')


def operands(torch, name: str, gen):
    """``(a, b, b_kn, alpha, bias)`` of one case, as the path gives them:
    the linears' rows and (O, I) weight; ``QKᵀ`` and ``PV`` on the head
    views of one (B, N, 3, H, D) qkv tensor, P the softmax's contiguous
    (B, H, N, N)."""
    rows = BATCH * TOKENS
    for lname, k, n in LINEARS:
        if lname == name:
            a = torch.randn(rows, k, device='cuda', generator=gen)
            w = torch.randn(n, k, device='cuda', generator=gen) * k ** -0.5
            bias = torch.randn(n, device='cuda', generator=gen)
            return a, w, False, 1.0, bias
    qkv = torch.randn(BATCH, TOKENS, 3, HEADS, WIDTH // HEADS, device='cuda',
                      generator=gen)
    q, k, v = (t.transpose(1, 2) for t in qkv.unbind(2))      # (B, H, N, D)
    if name == 'QK^T':
        return q, k, False, (WIDTH // HEADS) ** -0.5, None
    p = torch.softmax(torch.randn(BATCH, HEADS, TOKENS, TOKENS, device='cuda',
                                  generator=gen), -1)
    return p, v, True, 1.0, None


def bound_ms(a, b, b_kn, bias) -> float:
    """The least time of the call: 3xTF32's operations at 495 TFLOP/s or
    its operands and output once at 3.35 TB/s, the larger."""
    m, k = a.shape[-2:]
    n = b.shape[-1] if b_kn else b.shape[-2]
    batch = a.numel() // (m * k)
    flops = 3 * 2 * batch * m * n * k
    nbytes = 4 * (a.numel() + b.numel() + batch * m * n
                  + (0 if bias is None else n))
    return max(flops / 495e12, nbytes / 3.35e12) * 1e3


def clip_step_operands(torch, batch: int = 8):
    """The 73 GEMM calls of CLIP ViT-B/32's step at ``batch`` frames (50
    tokens, width 768, 12 heads, MLP 3072, 12 layers and the 768 -> 512
    projection), in the path's order, on the path's layouts."""
    tokens, width, heads, mlp = 50, 768, 12, 3072
    hd = width // heads
    gen = torch.Generator(device='cuda').manual_seed(11)

    def t(*shape):
        return torch.randn(*shape, device='cuda', generator=gen)
    x, h = t(batch * tokens, width), t(batch * tokens, mlp)
    w = {'in': t(3 * width, width), 'out': t(width, width),
         'fc': t(mlp, width), 'proj': t(width, mlp)}
    bias = {key: t(v.shape[0]) for key, v in w.items()}
    qkv = t(batch, tokens, 3 * width)
    q, k, v = (c.reshape(batch, tokens, heads, hd).transpose(1, 2)
               for c in qkv.chunk(3, dim=-1))
    p = torch.softmax(t(batch, heads, tokens, tokens), -1)
    layer = [(x, w['in'], False, 1.0, bias['in']), (q, k, False, hd ** -0.5, None),
             (p, v, True, 1.0, None), (x, w['out'], False, 1.0, bias['out']),
             (x, w['fc'], False, 1.0, bias['fc']),
             (h, w['proj'], False, 1.0, bias['proj'])]
    return layer * 12 + [(t(batch, width), t(width, 512), True, 1.0, None)]


def host_us_per_launch(torch, gemm, batch: int = 8, rounds: int = 20) -> float:
    """The wrapper's host µs per launch: the host clock around ``rounds``
    runs of CLIP ViT-B/32's 73 GEMM calls at ``batch`` (no synchronise
    inside a run: the launches queue), after one warm run, the fastest
    run over its 73 calls."""
    calls = clip_step_operands(torch, batch)
    for args in calls:
        gemm(*args)
    torch.cuda.synchronize()
    best = float('inf')
    for _ in range(rounds):
        t0 = time.perf_counter()
        for args in calls:
            gemm(*args)
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / len(calls) * 1e6


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--only', nargs='*', default=None,
                    help='variants (default: all), "a+b" for both patches')
    ap.add_argument('--design', choices=sorted(DESIGNS), default='ws',
                    help='the kernel (ws) or the lockstep yardstick')
    ap.add_argument('--yardstick', action='store_true',
                    help='also the lockstep design, in the same turns')
    ap.add_argument('--host', action='store_true',
                    help="also the wrapper's host µs per launch")
    args = ap.parse_args(argv)
    names = args.only or list(DESIGNS[args.design][1])
    _, _, wrapper, loader = DESIGNS[args.design]
    sys.path.insert(0, str(ROOT))
    import torch
    from video_features_torch.ops import gemm_tf32x3 as g
    from video_features_torch.utils.device import set_precision
    set_precision('highest')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(card, flush=True)
    if args.host:
        us = host_us_per_launch(torch, g.gemm_tf32x3)
        print(f'host us per launch, CLIP ViT-B/32 batch 8 (73 GEMMs): '
              f'{us:.2f} ({card})', flush=True)
    with ThreadPoolExecutor(len(names)) as pool:
        libs = dict(zip(names, pool.map(build, names,
                                        [args.design] * len(names))))
    gen = torch.Generator(device='cuda').manual_seed(5)

    def ms(fn, reps=10, replays=3):
        # from a CUDA graph of reps calls: the wrappers' host cost stays out
        fn()
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(reps):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(replays):
            graph.replay()
        b.record()
        torch.cuda.synchronize()
        return a.elapsed_time(b) / (reps * replays)

    library = getattr(g, loader)
    # the lockstep yardstick as a column of its own, in the same turns
    columns = names + (['lockstep'] if args.yardstick else [])
    totals = {v: 0.0 for v in columns}
    total_bound = 0.0
    try:
        for name in CASES:
            a, b, b_kn, alpha, bias = operands(torch, name, gen)
            want = g.gemm_tf32x3_plain(a, b, b_kn, alpha, bias)
            out = {}

            def call(v):
                if v == 'lockstep':
                    out[v] = g.gemm_tf32x3_lockstep(a, b, b_kn, alpha, bias)
                    return
                setattr(g, loader, lambda: libs[v])
                out[v] = getattr(g, wrapper)(a, b, b_kn, alpha, bias)
            times = {v: [] for v in columns}
            for v in columns + columns[::-1]:
                times[v].append(ms(lambda: call(v)))
            bound = bound_ms(a, b, b_kn, bias)
            total_bound += bound
            line = []
            for v in columns:
                t_ms = sum(times[v]) / len(times[v])
                totals[v] += 12 * t_ms
                line.append(f'{v} {t_ms:.4f} ms ({bound / t_ms:.1%})')
            rel = ''
            if 'kernel' in libs:
                call('kernel')
                got = out['kernel']
                rel = (f'kernel rel L2 '
                       f'{((got - want).norm() / want.norm()).item():.2e}; ')
            print(f'{name} ({tuple(a.shape)} x {tuple(b.shape)} '
                  f'{"(K, N)" if b_kn else "(N, K)"}; {rel}bound {bound:.4f} '
                  f'ms): {", ".join(line)} ({card})', flush=True)
            del a, b, bias, want, out
            torch.cuda.empty_cache()
    finally:
        setattr(g, loader, library)
    print(f'{args.design}: ViT-B/16 step (12 layers of the six): ' + ', '.join(
        f'{v} {totals[v]:.4f} ms ({12 * total_bound / totals[v]:.1%})'
        for v in columns) + f'; bound {12 * total_bound:.4f} ms ({card})',
        flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
