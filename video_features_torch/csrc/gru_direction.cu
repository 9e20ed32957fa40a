// One SepConvGRU direction of RAFT's update block for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel tools/gru_kernel_experiment.py::
// pallas_direction (body _kernel). With h and motion (M pixels, 128 channels
// each, channels-last), the direction's weights w_zr (256 out x 256 in per
// tap) and w_q (128 out x 256 in per tap) -- the in axis is [h | motion],
// zr's out axis is [z | r] -- and the precomputed context terms zr_term
// (M, 256) and q_term (M, 128):
//
//   zr  = sigmoid(sum_t [h, motion](p + t - 2) . w_zr[t] + zr_term)
//   q   = tanh(sum_t [r*h, motion](p + t - 2) . w_q[t] + q_term)
//   out = (1 - z) * h + z * q
//
// The tap offset runs along W (axis 'w', the 1x5 pass) or H (axis 'h', the
// 5x1 pass) with zero padding at the image's edge: a tap never reads into
// the next row or the next image of the batch.
//
// What bounds it on the H100: operations. Per pixel it does 2 * 1280 * 384 =
// 983,040 flops against 3 KB of input and output. The products run on the
// tensor cores in 3xTF32, which gives fp32-class results (the Hopper form of
// the Pallas kernel's bf16_3x split): each operand x splits into
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
// (cvt.rna.tf32.f32), and every K step accumulates lo*hi + hi*lo + hi*hi in
// fp32; the dropped lo*lo term is below fp32's rounding. That is three TF32
// products for each fp32 one, so the least time at the main path's batch-8
// shape (M = 128 pairs x 32 x 43 = 176,128; 1.73e11 flops) is
// 3 x 1.73e11 / 495 TFLOP/s = 1.05 ms, against 2.58 ms at the 67 TFLOP/s
// fp32 FMA rate and 0.16 ms for the 541 MB of h, motion, terms and output at
// 3.35 TB/s. cuDNN and cuBLAS keep TF32 off under precision=highest; this
// kernel's emulation is what makes the tensor cores usable there.
//
// Design: two implicit GEMMs, M = pixels, N = output channels, K = 5 taps x
// 256 input channels.
//
//   1. gru_tf32x3<WGS, true, PASSES>: the 256-wide zr GEMM (two blocks along N) with
//      the sigmoid epilogue. The z half (blockIdx.y == 0) writes z; the r
//      half writes r*h, which is the q GEMM's input. Writing and reading both
//      back is 4 x M x 512 bytes, ~0.1 ms at the batch-8 shape.
//   2. gru_tf32x3<WGS, false, PASSES>: the 128-wide q GEMM over [r*h, motion] with
//      the tanh and blend epilogue.
//
// Two launches instead of one because the q GEMM needs r at the neighbouring
// pixels; one launch would have to recompute the zr GEMM over a +-2 halo.
//
// A block computes BM = 64 * WGS pixels x 128 output channels with WGS
// warpgroups of 64 rows; each issues wgmma.mma_async.m64n128k8.f32.tf32.tf32
// with A from registers and B from shared memory. No producer warp: every
// thread stages activations, thread 0 issues the weight copies, and the
// warpgroups meet only on mbarriers, never on a block-wide barrier, so one
// can queue products while the other sums or loads.
//
//   * Activations (A): the K loop walks 8 slices of 32 input channels (h's
//     or r*h's four, then motion's four). For each slice the block stages
//     its pixel rows with their halo once, by 16-byte cp.async (source size
//     0 where the halo leaves the tensor), and runs all five taps from them:
//     20 K steps of 8 channels. The halo is +-2 pixels for axis 'w' and
//     +-2 rows of W pixels for axis 'h'; when W exceeds BM the five tap
//     windows are staged apart (5 x BM rows) instead of as one run. Rows are
//     36 floats apart so that a fragment's rows hit distinct banks. Two
//     slice buffers: the next slice's copies overlap this one's products;
//     an mbarrier per buffer counts the copies in (cp.async.mbarrier.arrive)
//     and another the warpgroups out. Each thread loads its fragments
//     (8 channels of each of its 2 rows per tap: two 16-byte loads a row,
//     which the packed weights' K order allows), zeroes the rows whose tap
//     leaves the image, and splits hi and lo in registers; the next tap's
//     fragments load while the tensor cores run this tap's 12 products.
//   * Weights (B): wgmma's tf32 form reads only K-major B, so the weights
//     are packed once per RAFT forward (ops/gru.py::pack_direction) as
//     (hi | lo, 5 taps, 8 slices, out, 32 channels), already hi/lo split and
//     laid out in the 128-byte swizzle that the wgmma descriptor names. Each
//     (tap, slice) tile of 128 outputs is a contiguous 16 KB per part, so one
//     bulk TMA copy (cp.async.bulk) per part fills a stage and completes on
//     a "full" mbarrier; a ring of 3 stages runs two taps ahead, each stage
//     refilled once both warpgroups have arrived on its "empty" mbarrier.
//   * Accumulation: each tap's 12 products (4 K steps x 3) go into a fresh
//     accumulator, which is then added to the running sum in fp32. The
//     tensor cores' accumulator truncates: summing all 480 products of a
//     pixel in it measured ~2e-5 off against float64 at the main path's
//     shapes, against ~1e-6 this way (the dropped fourth product, lo*lo,
//     moved nothing).
//   * Tiles: BM = 128 (two warpgroups) wherever a slice's staged rows fit
//     in shared memory (W <= 83 for axis 'h'), else 64.
//
// One pass (the precision lanes that JAX runs in one pass: default,
// tensorfloat32, bfloat16): each K step issues only hi*hi, the activations
// are rounded to TF32 with no lo split, and only the hi part of each weight
// tile is read, so a third of the products. The least time at the batch-8
// shape is then 1.73e11 / 495 TFLOP/s = 0.35 ms. gru_tf32x3<WGS, ZR, 1>
// did that on the schedule above and reached 27% of it: every block
// streamed the direction's whole weight set (40 tiles x 16 KB) through L2
// for 128 pixels, 2.71 GB per direction for 1.3 MB of weights, and drained
// the tensor cores at every tap. The entry point runs gru_tf32_onepass
// instead (its own note, below); the PASSES = 1 instantiation stays as the
// yardstick that tools/gru_tf32x3_variants.py builds. PASSES = 3 is the
// kernel above, bit for bit.
//
// No split-K and no atomics: every output is written once by one thread, so
// results are deterministic. The TPU kernel's (W, M, C) transposed VMEM
// buffer is an artifact of the TPU and is not carried over.
//
// The entry point launches on the given stream, does not synchronize, and
// returns a CUDA error code (0 on success) so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kC = 128;                  // hidden and motion channels
constexpr int kIn = 2 * kC;              // input channels per tap
constexpr int kTaps = 5;
constexpr int kSlice = 32;               // input channels per staged slice
constexpr int kSlices = kIn / kSlice;    // 8
constexpr int kSteps = kSlices * kTaps;  // 40 (slice, tap) steps
constexpr int kBN = 128;                 // output channels per block
constexpr int kStages = 3;               // weight ring
constexpr int kLda = kSlice + 4;         // floats per staged activation row
constexpr int kTileBytes = kBN * kSlice * 4;        // 16 KB: one part of a tile
constexpr int kStageBytes = 2 * kTileBytes;         // hi and lo

struct Args {
  const float* src0;     // conv input channels 0..127: h (zr) or r*h (q)
  const float* src1;     // conv input channels 128..255: motion
  const float* w;        // packed (2, 5, 8, n_out, 32)
  const float* term;     // (M, n_out)
  const float* h;        // (M, 128)
  const float* z;        // (M, 128), read by the q epilogue
  float* out0;           // zr: z; q: the new h
  float* out1;           // zr: r*h
  int m, height, width, axis_h, n_out;
  int stride;            // pixels between taps: 1 (axis 'w') or W (axis 'h')
  int gap;               // staged rows between tap windows: min(stride, BM)
};

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TF32 rounding to nearest, ties away from zero: cvt.rna.tf32.f32 for
// finite x, in two integer operations.
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One bulk TMA copy per part (hi, and lo when PASSES = 3) of a weight tile,
// completing on bar.
template <int PASSES>
__device__ __forceinline__ void load_weights(uint32_t dst, const float* hi,
                                             const float* lo, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(PASSES == 3 ? kStageBytes : kTileBytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(hi), "r"(kTileBytes), "r"(bar) : "memory");
  if constexpr (PASSES == 3)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst + kTileBytes), "l"(lo), "r"(kTileBytes), "r"(bar)
        : "memory");
}

// K-major B in the 128-byte swizzle: rows of 128 bytes (32 tf32 along K),
// 8-row groups 1024 bytes apart (SBO); a K step of 8 advances 32 bytes.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | ((uint64_t)1 << 16)                       // LBO (unused when swizzled)
       | ((uint64_t)(1024 >> 4) << 32)             // SBO
       | ((uint64_t)1 << 62);                      // 128-byte swizzle
}

__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "
      "%58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Staged activation rows a block needs for one slice.
__host__ __device__ __forceinline__ int staged_rows(int bm, int gap) {
  return bm + 4 * gap;
}

size_t smem_bytes(int bm, int gap) {
  return 1024 + (size_t)kStages * kStageBytes
       + 2 * (size_t)staged_rows(bm, gap) * kLda * 4 + (2 * kStages + 4) * 8;
}

// WGS: warpgroups (BM = 64 * WGS pixels per block).
// ZR: the zr GEMM and its epilogue, else the q GEMM and its epilogue.
// PASSES: TF32 products per fp32 product, 3 (3xTF32) or 1.
template <int WGS, bool ZR, int PASSES>
__global__ void __launch_bounds__(WGS * 128, 1)
gru_tf32x3(Args a) {
  constexpr int BM = 64 * WGS;
  constexpr int kThreads = WGS * 128;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled weight tiles want 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* bstage = base;                                   // kStages x 32 KB
  const int rows = staged_rows(BM, a.gap);
  float* astage = reinterpret_cast<float*>(base + kStages * kStageBytes);
  // full[s]: stage s's weights arrived; empty[s]: both warpgroups are done
  // with them
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(astage) + 2 * (size_t)rows * kLda * 4);
  uint64_t* empty = full + kStages;
  // afull[b]: activation buffer b's rows arrived (every thread's copies);
  // aempty[b]: both warpgroups have read their fragments from it
  uint64_t* afull = empty + kStages;
  uint64_t* aempty = afull + 2;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int wg = tid / 128;
  const int warp = (tid / 32) % 4;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(smem_addr(&full[i]), 1);
      mbar_init(smem_addr(&empty[i]), WGS);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_addr(&afull[i]), kThreads);
      mbar_init(smem_addr(&aempty[i]), WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // weight tile of step (slice, tap) for this block's 128 outputs
  const int64_t part_size = (int64_t)kTaps * kSlices * a.n_out * kSlice;
  auto issue_weights = [&](int step) {
    const int slice = step / kTaps, tap = step % kTaps;
    const float* src = a.w + ((int64_t)(tap * kSlices + slice) * a.n_out + n0)
                               * kSlice;
    const int s = step % kStages;
    // the stage's previous use, step - kStages, released by both warpgroups
    if (step >= kStages) mbar_wait(smem_addr(&empty[s]), (step / kStages - 1) & 1);
    load_weights<PASSES>(smem_addr(bstage + s * kStageBytes), src,
                         src + part_size, smem_addr(&full[s]));
  };
  // the block's pixel rows of one slice, with their halo
  auto issue_activations = [&](int slice, int buf) {
    const float* src = slice < kSlices / 2 ? a.src0 : a.src1;
    const int c0 = (slice % (kSlices / 2)) * kSlice;
    float* dst = astage + (size_t)buf * rows * kLda;
    for (int i = tid; i < rows * (kSlice / 4); i += kThreads) {
      const int row = i / (kSlice / 4), chunk = i % (kSlice / 4);
      const int p = a.gap == a.stride
          ? m0 - 2 * a.stride + row
          : m0 + (row / BM - 2) * a.stride + row % BM;
      const bool valid = p >= 0 && p < a.m;
      const float* g = src + (valid ? (int64_t)p * kC + c0 + chunk * 4 : 0);
      cp_async16(smem_addr(dst + row * kLda + chunk * 4), g, valid);
    }
    // arrives on afull[buf] once this thread's copies have landed
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_addr(&afull[buf])) : "memory");
  };

  // this thread's two pixels (fragment rows g and g + 8 of its warp) and
  // their positions along the tap axis
  const int r0 = wg * 64 + warp * 16 + lane / 4;
  const int extent = a.axis_h ? a.height : a.width;
  int pos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + r0 + 8 * i;
    // a pixel past the end gets a position that fails every tap's mask
    pos[i] = p >= a.m ? -(1 << 20)
           : (a.axis_h ? (p / a.width) % a.height : p % a.width);
  }

  // A fragments of one tap step: 4 K steps of 8 channels, each split into
  // TF32 hi and lo (hi alone in one pass); rows whose tap leaves the image
  // are zeros. The packed
  // weights order each slice's 32 channels so that K step k's fragment
  // columns t and t + 4 are channels 8t + 2k and 8t + 2k + 1: a thread's
  // 8 channels of a row are contiguous, two 16-byte loads.
  auto load_fragments = [&](const float* as, int tap, uint32_t (&hi)[4][4],
                            uint32_t (&lo)[4][4]) {
    const int d = tap - kTaps / 2;
    const bool ok0 = pos[0] + d >= 0 && pos[0] + d < extent;
    const bool ok1 = pos[1] + d >= 0 && pos[1] + d < extent;
    const float* row0 = as + (tap * a.gap + r0) * kLda + 8 * (lane % 4);
    const float* row1 = row0 + 8 * kLda;
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
    const float4 x[4] = {
        ok0 ? *reinterpret_cast<const float4*>(row0) : zero,
        ok0 ? *reinterpret_cast<const float4*>(row0 + 4) : zero,
        ok1 ? *reinterpret_cast<const float4*>(row1) : zero,
        ok1 ? *reinterpret_cast<const float4*>(row1 + 4) : zero};
    // fragment order: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    const float v[4][4] = {{x[0].x, x[2].x, x[0].y, x[2].y},
                           {x[0].z, x[2].z, x[0].w, x[2].w},
                           {x[1].x, x[3].x, x[1].y, x[3].y},
                           {x[1].z, x[3].z, x[1].w, x[3].w}};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        hi[k][j] = tf32_rna(v[k][j]);
        if constexpr (PASSES == 3)
          lo[k][j] = tf32_rna(v[k][j] - __uint_as_float(hi[k][j]));
      }
  };

  // acc: the running sum; part: one tap's 12 products, 4 in one pass
  // (see the note)
  float acc[64], part[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = part[i] = 0.f;

  issue_activations(0, 0);
  if (tid == 0)
    for (int s = 0; s < kStages - 1; ++s) issue_weights(s);

  // two fragment sets by tap parity: the next tap's loads go into the
  // set the tensor cores are not reading
  uint32_t frag[2][2][4][4];                    // [set][hi, lo][k][4]
#pragma unroll 1
  for (int slice = 0; slice < kSlices; ++slice) {
    const int buf = slice & 1;
    if (slice + 1 < kSlices) {
      // the other buffer, once both warpgroups have read slice - 1 from it
      if (slice > 0) mbar_wait(smem_addr(&aempty[buf ^ 1]), ((slice - 1) / 2) & 1);
      issue_activations(slice + 1, buf ^ 1);
    }
    mbar_wait(smem_addr(&afull[buf]), (slice / 2) & 1);
    const float* as = astage + (size_t)buf * rows * kLda;
    load_fragments(as, 0, frag[0][0], frag[0][1]);
#pragma unroll
    for (int tap = 0; tap < kTaps; ++tap) {
      const int step = slice * kTaps + tap;
      const int s = step % kStages;
      const int cur = tap & 1;
      mbar_wait(smem_addr(&full[s]), (step / kStages) & 1);
      const uint32_t bhi = smem_addr(bstage + s * kStageBytes);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint64_t dhi = b_desc(bhi + k * 32);
        const uint64_t dlo = b_desc(bhi + kTileBytes + k * 32);
        const uint32_t (&hi)[4] = frag[cur][0][k];
        const uint32_t (&lo)[4] = frag[cur][1][k];
        if constexpr (PASSES == 3) {
          wgmma_m64n128k8(part, lo, dhi, k > 0);      // k = 0 starts afresh
          wgmma_m64n128k8(part, hi, dlo, 1);
          wgmma_m64n128k8(part, hi, dhi, 1);
        } else {
          wgmma_m64n128k8(part, hi, dhi, k > 0);
        }
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      // thread 0 keeps the weight ring two steps ahead, after its own
      // warpgroup's products are queued
      if (tid == 0 && step + kStages - 1 < kSteps)
        issue_weights(step + kStages - 1);
      __syncwarp();
      // the next tap's fragments load while the tensor cores run this one's
      if (tap + 1 < kTaps)
        load_fragments(as, tap + 1, frag[cur ^ 1][0], frag[cur ^ 1][1]);
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      // this warpgroup is done with the weight stage and, after the last
      // tap's fragments, with the slice's rows; no block-wide barrier
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      if (tid % 128 == 0) {
        asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                     :: "r"(smem_addr(&empty[s])) : "memory");
        if (tap + 2 == kTaps)
          asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
                       :: "r"(smem_addr(&aempty[buf])) : "memory");
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] += part[i];
    }
  }

  // Epilogue: acc[4j + 2i + e] is pixel m0 + r0 + 8i, channel 8j + 2t + e of
  // this block's 128 (t = lane % 4).
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + r0 + 8 * i;
    if (p >= a.m) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int n = 8 * j + 2 * (lane % 4);               // channel in [0, 128)
      const float2 t = __ldg(reinterpret_cast<const float2*>(
          a.term + (int64_t)p * a.n_out + n0 + n));
      const float s0 = acc[4 * j + 2 * i] + t.x;
      const float s1 = acc[4 * j + 2 * i + 1] + t.y;
      const int64_t o = (int64_t)p * kC + n;
      if constexpr (ZR) {
        const float v0 = sigmoid(s0), v1 = sigmoid(s1);
        if (blockIdx.y == 0) {
          *reinterpret_cast<float2*>(a.out0 + o) = make_float2(v0, v1);   // z
        } else {
          const float2 h = __ldg(reinterpret_cast<const float2*>(a.h + o));
          *reinterpret_cast<float2*>(a.out1 + o) =                         // r*h
              make_float2(v0 * h.x, v1 * h.y);
        }
      } else {
        const float2 h = __ldg(reinterpret_cast<const float2*>(a.h + o));
        const float2 z = __ldg(reinterpret_cast<const float2*>(a.z + o));
        *reinterpret_cast<float2*>(a.out0 + o) = make_float2(
            (1.0f - z.x) * h.x + z.x * tanhf(s0),
            (1.0f - z.y) * h.y + z.y * tanhf(s1));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The one-pass kernel: gru_tf32_onepass<WGS, ZR>, the same two GEMMs and
// epilogues in one TF32 pass (hi*hi; the A fragments rounded by tf32_rna in
// registers, the taps masked per row at the image's edge). Per 128-pixel
// block a tap's 4 products (m64n128k8 per warpgroup) take 512 tensor-core
// cycles and need a 16 KB weight tile: 32 B per cycle per SM, 7.4 TB/s
// from L2 over 132 SMs at the bound, which is why the design cuts the
// weight stream. On the card (tools/gru_tf32x3_variants.py, NVIDIA H100
// 80GB HBM3, 700 W) the feed turned out not to be what held the
// instantiation of gru_tf32x3 back: its floors with no products and with
// no refills are both near its time, a cluster of 1 runs as fast as one of
// 2, and the time went to draining the tensor cores at every tap, to
// registers (spills make ptxas serialise wgmma) and to the epilogue's
// round trips. The layout:
//
//   * Clusters along M: kCluster CTAs on neighbouring M-tiles with the same
//     128 outputs share every weight tile. Each CTA fetches 1/kCluster of
//     the tile and multicasts it to all of them at the same shared-memory
//     offset (cp.async.bulk ... .multicast::cluster), completing on each
//     CTA's "full" mbarrier, which expects the whole 16 KB. A stage is
//     refilled only once every consumer warp of every CTA has released it:
//     each arrives on every CTA's "empty" mbarrier (mapa and a remote
//     arrive in CUTLASS's form; an explicit .release.cluster arrive costs
//     a fence on every call). The weight stream falls by kCluster: 2.71 GB
//     -> 1.35 GB per direction at the batch-8 shape.
//   * A producer warpgroup: its thread 0 issues the weight copies, and its
//     128 threads stage each slice's activation rows by cp.async
//     (zero-filled past the tensor), completing on the slice buffer's
//     "afull" mbarrier. The consumer warpgroups only load fragments, round,
//     issue wgmma and run the epilogue. The register file is handed out by
//     warpgroup, so a lone producer warp would cost a warpgroup's registers
//     all the same (168 a thread at 3 warpgroups, where the consumers
//     spill); instead the producers give theirs away (setmaxnreg.dec to
//     56) and the consumers take them (setmaxnreg.inc to 224). One-pass
//     stages are 16 KB, so the ring runs up to kRingMax = 8 deep (a 3-deep
//     ring measured 28-42% slower).
//   * Fewer drains: a tap's 4 products are one wgmma group, and the fp32
//     flush is widened from every tap to every slice (kFlushTaps = 5 taps,
//     20 K steps summed in the tensor cores' accumulator before the fp32
//     add): 8 flushes per tile instead of 40 (every tap measured 38%
//     slower). Against
//     the plain version that moved the mean error from 4.1e-7 to 4.9e-7
//     and left the max at the r*h rounding flips' ~9e-5, inside the
//     one-pass bounds (5e-4, 1e-6); the 3xTF32 kernel keeps its per-tap
//     flush. Each group is waited for before the next is queued
//     (kInFlight = 0): leaving one running (1) keeps a second fragment set
//     live, which spills, and measured 2-4% slower. The loop body is one
//     slice, so taps and fragment sets are known at compile time (a
//     runtime tap put the flush in a branch, and ptxas serialised the
//     products). Empty asm statements that name the sums and fragments
//     (fence_regs) pin every read of a sum and every write of a fragment
//     after the wait that frees it; without them the compiler may hoist
//     one above the wait, and ptxas then serialises the products too.
//   * The epilogue reads term, h and z (540 MB per direction at the batch-8
//     shape) at the tile's end, with nothing to overlap: its loads, one
//     round trip after another behind stores that may alias them, cost
//     ~0.15-0.2 ms. They are issued in batches of kEpilogueBatch channel
//     pairs before their stores (a prefetch of the rows into L2 mid-tile
//     gained nothing: the round trips, not the bytes, cost the time).
//
// A CTA past the last M-tile (the grid is a whole number of clusters) has
// no rows: it stages zeros, takes part in every multicast and barrier, and
// writes nothing. Each CTA starts after a cluster barrier (no peer writes
// into barriers before they exist) and ends with one (no CTA leaves while a
// peer may still arrive on its barriers). Every wait is bounded: a barrier
// that never completes traps (a launch error) instead of hanging the card.
// Tiles: BM = 128 where the staged rows leave room for kRingWide stages
// (axis 'h' with W <= 83), else 64.
constexpr int kCluster = 2;              // CTAs per cluster sharing a tile
constexpr int kRingMax = 8;              // deepest weight ring, 16 KB stages
constexpr int kRingWide = 6;             // stages that BM = 128 must leave
constexpr int kActBufs = 2;              // slice buffers: staged a slice ahead
constexpr int kProducers = 128;          // one warpgroup
constexpr int kProducerRegs = 56, kConsumerRegs = 224;   // setmaxnreg
constexpr int kInFlight = 0;             // wgmma groups left running at a wait
constexpr int kFlushTaps = 5;            // taps summed in the tensor cores
constexpr int kEpilogueBatch = 8;        // channel pairs loaded together
constexpr uint32_t kSpinLimit = 1u << 26;

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// every thread of every CTA of the cluster, divergent or not
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n"
               "barrier.cluster.wait;\n" ::: "memory");
}

// mbar_wait, bounded
__device__ __forceinline__ void mbar_wait_bounded(uint32_t bar, int parity) {
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n" : "=r"(done) : "r"(bar), "r"(parity) : "memory");
    if (done) return;
    if (spin == kSpinLimit) __trap();
  }
}

// where on: arrive on the mbarrier at the same offset as bar in cluster CTA
// rank (the form of CUTLASS's ClusterBarrier::arrive: an explicit
// .release.cluster arrive costs a fence on every call). Predicated, not
// branched: ptxas serialises wgmma around divergent paths.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar, uint32_t rank,
                                                   bool on) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      ".reg .b32 remote;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "@p mbarrier.arrive.shared::cluster.b64 _, [remote];\n"
      "}\n" :: "r"(bar), "r"(rank), "r"((int)on) : "memory");
}

// where on: arrive on this CTA's mbarrier bar, predicated
__device__ __forceinline__ void mbar_arrive_if(uint32_t bar, bool on) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n"
      "}\n" :: "r"(bar), "r"((int)on) : "memory");
}

// bytes from src into every CTA of the cluster at dst, completing on the
// mbarrier at bar's offset in each
__device__ __forceinline__ void bulk_multicast(uint32_t dst, const void* src,
                                               int bytes, uint32_t bar) {
  if constexpr (kCluster == 1)
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
  else
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        ".multicast::cluster [%0], [%1], %2, [%3], %4;\n"
        :: "r"(dst), "l"(src), "r"(bytes), "r"(bar),
           "h"((uint16_t)((1u << kCluster) - 1)) : "memory");
}

// pin the compiler's reads and writes of r to this point in the program
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

size_t onepass_smem(int bm, int gap, int stages) {
  return 1024 + (size_t)stages * kTileBytes
       + kActBufs * (size_t)staged_rows(bm, gap) * kLda * 4
       + (2 * kRingMax + 2 * kActBufs) * 8;
}

// WGS: consumer warpgroups (BM = 64 * WGS pixels per CTA); ZR as above;
// stages: the weight ring's depth, 2..kRingMax, as the host sized it.
template <int WGS, bool ZR>
__global__ void __launch_bounds__(WGS * 128 + kProducers, 1)
gru_tf32_onepass(Args a, int stages) {
  constexpr int BM = 64 * WGS;
  constexpr int kConsumers = WGS * 128;
  constexpr int kConsumerWarps = WGS * 4;
  extern __shared__ uint8_t smem_raw[];
  // the same offsets in every CTA, which the multicast relies on
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t bstage = smem_addr(base);                  // stages x 16 KB
  const int rows = staged_rows(BM, a.gap);
  float* astage = reinterpret_cast<float*>(base + (size_t)stages * kTileBytes);
  // full[s]: stage s's tile arrived (16 KB from all the cluster's CTAs);
  // empty[s]: every consumer warp of the cluster is done with it
  uint64_t* full = reinterpret_cast<uint64_t*>(
      reinterpret_cast<uint8_t*>(astage) + kActBufs * (size_t)rows * kLda * 4);
  uint64_t* empty = full + kRingMax;
  // afull[b]: activation buffer b's rows arrived (every producer thread's
  // copies); aempty[b]: every consumer warp has loaded its fragments
  uint64_t* afull = empty + kRingMax;
  uint64_t* aempty = afull + kActBufs;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;

  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      mbar_init(smem_addr(&full[i]), 1);
      mbar_init(smem_addr(&empty[i]), kConsumerWarps * kCluster);
    }
    for (int i = 0; i < kActBufs; ++i) {
      mbar_init(smem_addr(&afull[i]), kProducers);
      mbar_init(smem_addr(&aempty[i]), kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();

  // one if-else for the whole kernel, as setmaxnreg needs; at WGS = 1 (256
  // threads) every thread has its 255 registers already
  if (tid >= kConsumers) {
    // ---- producer warpgroup ----
    if constexpr (WGS == 2)
      asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(kProducerRegs));
    const int ptid = tid - kConsumers;
    const uint32_t rank = cluster_rank();
    constexpr int kShare = kTileBytes / kCluster;
    // this CTA's share of step w's hi tile (this block's 128 outputs), to
    // every CTA's stage s
    auto issue_weights = [&](int w, int s) {
      const int slice = w / kTaps, tap = w % kTaps;
      const float* src = a.w + ((int64_t)(tap * kSlices + slice) * a.n_out + n0)
                                 * kSlice + rank * (kShare / 4);
      const uint32_t bar = smem_addr(&full[s]);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(bar), "r"(kTileBytes) : "memory");
      bulk_multicast(bstage + s * kTileBytes + rank * kShare, src, kShare, bar);
    };
    // the CTA's pixel rows of one slice, with their halo, into buffer
    // slice % kActBufs: this thread's 16-byte chunk of every 16th row
    constexpr int kChunks = kSlice / 4, kRowStep = kProducers / kChunks;
    const int chunk = ptid % kChunks;
    auto issue_activations = [&](int slice) {
      const float* src = (slice < kSlices / 2 ? a.src0 : a.src1)
                       + (slice % (kSlices / 2)) * kSlice + chunk * 4;
      const uint32_t dst = smem_addr(astage + (size_t)(slice % kActBufs) * rows * kLda
                                     + chunk * 4);
      for (int row = ptid / kChunks; row < rows; row += kRowStep) {
        const int p = a.gap == a.stride
            ? m0 - 2 * a.stride + row
            : m0 + (row / BM - 2) * a.stride + row % BM;
        const bool valid = p >= 0 && p < a.m;
        cp_async16(dst + row * kLda * 4, src + (valid ? (int64_t)p * kC : 0),
                   valid);
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                   :: "r"(smem_addr(&afull[slice % kActBufs])) : "memory");
    };
    // slice g's buffer is free once the consumers have read slice
    // g - kActBufs
    auto stage_slice = [&](int g) {
      if (g >= kActBufs)
        mbar_wait_bounded(smem_addr(&aempty[g % kActBufs]),
                          (g / kActBufs - 1) & 1);
      issue_activations(g);
    };
    const int wsteps = kSteps, aslices = kSlices;   // streamed, in full
    int next = 0;
    for (; next < kActBufs && next < aslices; ++next) stage_slice(next);
    int s = 0, ph = 0;
    for (int w = 0; w < wsteps; ++w) {
      if (w >= stages) {
        // every consumer of the cluster has released step w - stages, so
        // slices whose buffer that frees (past slice g - kActBufs's last
        // tap, step kTaps * (g - kActBufs + 1) - 1) are staged now, ahead
        // of their use
        mbar_wait_bounded(smem_addr(&empty[s]), ph ^ 1);
        while (next < aslices
               && w - stages >= kTaps * (next - kActBufs + 1) - 1)
          stage_slice(next++);
      }
      if (ptid == 0) issue_weights(w, s);
      __syncwarp();
      if (++s == stages) { s = 0; ph ^= 1; }
    }
    while (next < aslices) stage_slice(next++);
    cluster_sync();
  } else {
    // ---- consumer warpgroups ----
    if constexpr (WGS == 2)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(kConsumerRegs));
    const int wg = tid / 128;
    const int warp = (tid / 32) % 4;
    // this thread's two pixels (fragment rows g and g + 8 of its warp) and
    // their positions along the tap axis
    const int r0 = wg * 64 + warp * 16 + lane / 4;
    const int extent = a.axis_h ? a.height : a.width;
    int pos[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = m0 + r0 + 8 * r;
      // a pixel past the end gets a position that fails every tap's mask
      pos[r] = p >= a.m ? -(1 << 20)
             : (a.axis_h ? (p / a.width) % a.height : p % a.width);
    }
    // A fragments of one tap of slice g: 4 K steps of 8 channels rounded to
    // TF32, rows whose tap leaves the image zeros (gru_tf32x3's
    // load_fragments)
    auto load_fragments = [&](int g, int tap, uint32_t (&f)[4][4]) {
      const float* as = astage + (size_t)(g % kActBufs) * rows * kLda;
      const int d = tap - kTaps / 2;
      const bool ok0 = pos[0] + d >= 0 && pos[0] + d < extent;
      const bool ok1 = pos[1] + d >= 0 && pos[1] + d < extent;
      const float* row0 = as + (tap * a.gap + r0) * kLda + 8 * (lane % 4);
      const float* row1 = row0 + 8 * kLda;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 x[4] = {
          ok0 ? *reinterpret_cast<const float4*>(row0) : zero,
          ok0 ? *reinterpret_cast<const float4*>(row0 + 4) : zero,
          ok1 ? *reinterpret_cast<const float4*>(row1) : zero,
          ok1 ? *reinterpret_cast<const float4*>(row1 + 4) : zero};
      const float v[4][4] = {{x[0].x, x[2].x, x[0].y, x[2].y},
                             {x[0].z, x[2].z, x[0].w, x[2].w},
                             {x[1].x, x[3].x, x[1].y, x[3].y},
                             {x[1].z, x[3].z, x[1].w, x[3].w}};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int j = 0; j < 4; ++j) f[k][j] = tf32_rna(v[k][j]);
    };
    // where on: this warp is done with weight stage s; tell every CTA's
    // producer
    auto release = [&](int s, bool on) {
      __syncwarp();
#pragma unroll
      for (int r = 0; r < kCluster; ++r)
        mbar_arrive_remote(smem_addr(&empty[s]), r, on && lane == 0);
    };

    // acc: the running sum; psum: kFlushTaps taps' products, summed in the
    // tensor cores
    float acc[64], psum[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = psum[i] = 0.f;
    // two fragment sets: step k + 1's load runs beside step k's products,
    // which read the other set
    uint32_t frag[2][4][4];
    // the ring's position at step K
    int s = 0, ph = 0, prev = 0;
    // the stage of the current step, once its tile has arrived
    auto wait_weights = [&]() {
      mbar_wait_bounded(smem_addr(&full[s]), ph);
      return bstage + s * kTileBytes;
    };
    // step K's fragments (tap `tap` of its slice) into f, whose last reader
    // (step K - 2's group) is done; after a slice's last tap the warp is
    // done with its rows. Past the last step (in = false)
    // the registers are loaded all the same, from a stale buffer and never
    // used, so that no fragment write sits in a branch.
    auto prefetch = [&](int K, int tap, bool in, uint32_t (&f)[4][4]) {
      const int g = K / kTaps;
      if (tap == 0 && in)
        mbar_wait_bounded(smem_addr(&afull[g % kActBufs]),
                          (g / kActBufs) & 1);
      fence_regs(f[0]);
      fence_regs(f[1]);
      fence_regs(f[2]);
      fence_regs(f[3]);
      load_fragments(g, tap, f);
      if (tap == kTaps - 1) {
        __syncwarp();
        mbar_arrive_if(smem_addr(&aempty[g % kActBufs]), lane == 0 && in);
      }
    };
    // Step K (tap `tap` of its slice, known at compile time) queues
    // its 4 products into psum, which restarts at each flush; waits for
    // its group (wait_group kInFlight = 0; at 1, step K - 1's), which frees
    // step K - 1's weight stage and fragment set; loads step K + 1's
    // fragments while the other warpgroup's products run; and
    // after every kFlushTaps taps (and a slice's last) drains and adds psum
    // to acc in fp32. psum is read only after wait_group 0: ptxas
    // serialises wgmma when a running group's sums are read. A slice's
    // last tap loads the next slice's first fragments after its drain, into
    // the set it has just freed, so that every slice uses the sets in the
    // same order. last: the last step.
    auto step = [&](int K, int tap, bool last, uint32_t (&f)[4][4],
                    uint32_t (&fnext)[4][4]) {
      const uint32_t b = wait_weights();
      fence_regs(psum);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_m64n128k8(psum, f[kk], b_desc(b + kk * 32),
                        kk > 0 || tap % kFlushTaps != 0);
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_regs(psum);
      wgmma_wait<kInFlight>();
      release(prev, K > 0);
      if (tap < kTaps - 1) prefetch(K + 1, tap + 1, true, fnext);
      if (tap % kFlushTaps == kFlushTaps - 1 || tap == kTaps - 1) {
        wgmma_wait<0>();
        fence_regs(psum);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += psum[i];
      }
      if (tap == kTaps - 1) prefetch(K + 1, 0, !last, f);
      prev = s;
      if (++s == stages) { s = 0; ph ^= 1; }
    };
    static_assert(kTaps == 5, "the fragment sets below follow 5 taps");

    mbar_wait_bounded(smem_addr(&afull[0]), 0);
    load_fragments(0, 0, frag[0]);
    // one slice per iteration: sets 0, 1, 0, 1, 0
#pragma unroll 1
    for (int k0 = 0; k0 < kSteps; k0 += kTaps) {
      const bool last = k0 + kTaps == kSteps;
      step(k0, 0, false, frag[0], frag[1]);
      step(k0 + 1, 1, false, frag[1], frag[0]);
      step(k0 + 2, 2, false, frag[0], frag[1]);
      step(k0 + 3, 3, false, frag[1], frag[0]);
      step(k0 + 4, 4, last, frag[0], frag[1]);
    }

    // Epilogue: acc[4j + 2r + e] is pixel m0 + r0 + 8r, channel 8j + 2t + e
    // of this block's 128 (t = lane % 4), as in gru_tf32x3. The outputs may
    // alias the inputs as far as the compiler knows, so it keeps every load
    // after the stores before it: the loads of kEpilogueBatch channel pairs are
    // issued together, then their stores, 16 / kEpilogueBatch round trips to
    // memory instead of 16.
    const bool rh = ZR && blockIdx.y == 1;       // the r half writes r*h
#pragma unroll
    for (int j0 = 0; j0 < 16; j0 += kEpilogueBatch) {
      float2 t[2][kEpilogueBatch], hv[2][kEpilogueBatch], zv[2][kEpilogueBatch];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = m0 + r0 + 8 * r;
#pragma unroll
        for (int j = 0; j < kEpilogueBatch; ++j) {
          const int n = 8 * (j0 + j) + 2 * (lane % 4);
          const int64_t o = (int64_t)p * kC + n;
          t[r][j] = hv[r][j] = zv[r][j] = make_float2(0.f, 0.f);
          if (p >= a.m) continue;
          t[r][j] = __ldg(reinterpret_cast<const float2*>(
              a.term + (int64_t)p * a.n_out + n0 + n));
          if (!ZR || rh)
            hv[r][j] = __ldg(reinterpret_cast<const float2*>(a.h + o));
          if (!ZR) zv[r][j] = __ldg(reinterpret_cast<const float2*>(a.z + o));
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int p = m0 + r0 + 8 * r;
        if (p >= a.m) continue;
#pragma unroll
        for (int j = 0; j < kEpilogueBatch; ++j) {
          const int n = 8 * (j0 + j) + 2 * (lane % 4);
          const int64_t o = (int64_t)p * kC + n;
          const float s0 = acc[4 * (j0 + j) + 2 * r] + t[r][j].x;
          const float s1 = acc[4 * (j0 + j) + 2 * r + 1] + t[r][j].y;
          if constexpr (ZR) {
            const float v0 = sigmoid(s0), v1 = sigmoid(s1);
            if (rh)
              *reinterpret_cast<float2*>(a.out1 + o) =
                  make_float2(v0 * hv[r][j].x, v1 * hv[r][j].y);
            else
              *reinterpret_cast<float2*>(a.out0 + o) = make_float2(v0, v1);
          } else {
            *reinterpret_cast<float2*>(a.out0 + o) = make_float2(
                (1.0f - zv[r][j].x) * hv[r][j].x + zv[r][j].x * tanhf(s0),
                (1.0f - zv[r][j].y) * hv[r][j].y + zv[r][j].y * tanhf(s1));
          }
        }
      }
    }
    cluster_sync();
  }
}

// Raise a kernel's dynamic shared memory limit to the device's opt-in
// maximum, once per device ordinal (set: the kernel's own table). The
// runtime keeps a function's attributes per device context: a flag set
// once per process would leave a second card at the 48 KB default, where
// the launch fails with cudaErrorInvalidValue.
constexpr int kMaxDevices = 64;

cudaError_t raise_smem(const void* kernel, std::atomic<int>* set, int device,
                       int limit) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set[device].load(std::memory_order_acquire) == limit) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, limit);
  if (err == cudaSuccess) set[device].store(limit, std::memory_order_release);
  return err;
}

template <int WGS, bool ZR, int PASSES>
cudaError_t allow_smem(int device, int limit) {
  static std::atomic<int> set[kMaxDevices];
  return raise_smem(reinterpret_cast<const void*>(gru_tf32x3<WGS, ZR, PASSES>),
                    set, device, limit);
}

template <int WGS, bool ZR>
cudaError_t allow_onepass_smem(int device, int limit) {
  static std::atomic<int> set[kMaxDevices];
  return raise_smem(reinterpret_cast<const void*>(gru_tf32_onepass<WGS, ZR>),
                    set, device, limit);
}

template <int WGS, int PASSES>
int launch(Args zr, Args q, int device, int limit, cudaStream_t stream) {
  constexpr int BM = 64 * WGS;
  const int gap = zr.stride < BM ? zr.stride : BM;
  zr.gap = q.gap = gap;
  const size_t smem = smem_bytes(BM, gap);
  if (smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  cudaError_t err = allow_smem<WGS, true, PASSES>(device, limit);
  if (err == cudaSuccess) err = allow_smem<WGS, false, PASSES>(device, limit);
  if (err != cudaSuccess) return (int)err;
  const unsigned mblocks = (unsigned)((zr.m + BM - 1) / BM);
  gru_tf32x3<WGS, true, PASSES><<<dim3(mblocks, 2 * kC / kBN), WGS * 128,
                                  smem, stream>>>(zr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  gru_tf32x3<WGS, false, PASSES><<<dim3(mblocks, kC / kBN), WGS * 128,
                                   smem, stream>>>(q);
  return (int)cudaGetLastError();
}

// The one-pass kernel's tile and ring for a tap stride: BM = 128 where the
// staged rows leave room for kRingWide stages, else 64; as many stages as
// fit, up to kRingMax. wgs = 0: nothing fits.
struct OnePass {
  int wgs, gap, stages;
  size_t smem;
};

OnePass onepass_config(int stride, int limit) {
  for (int wgs = 2; wgs >= 1; --wgs) {
    const int bm = 64 * wgs, gap = stride < bm ? stride : bm;
    const long long room = (long long)limit - (long long)onepass_smem(bm, gap, 0);
    const long long fit = room > 0 ? room / kTileBytes : 0;
    if (fit >= (wgs == 2 ? kRingWide : 2)) {
      const int stages = fit < kRingMax ? (int)fit : kRingMax;
      return {wgs, gap, stages, onepass_smem(bm, gap, stages)};
    }
  }
  return {0, 0, 0, 0};
}

// a launch of gru_tf32_onepass<WGS, ·> in clusters of kCluster along x
template <int WGS>
cudaLaunchConfig_t onepass_launch(dim3 grid, const OnePass& c,
                                  cudaStream_t stream,
                                  cudaLaunchAttribute* cluster) {
  cluster->id = cudaLaunchAttributeClusterDimension;
  cluster->val.clusterDim.x = kCluster;
  cluster->val.clusterDim.y = 1;
  cluster->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(WGS * 128 + kProducers);
  cfg.dynamicSmemBytes = c.smem;
  cfg.stream = stream;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  return cfg;
}

template <int WGS, bool ZR>
cudaError_t launch_onepass_kernel(const Args& a, int blocks_n, const OnePass& c,
                                  int device, int limit, cudaStream_t stream) {
  constexpr int BM = 64 * WGS;
  cudaError_t err = allow_onepass_smem<WGS, ZR>(device, limit);
  if (err != cudaSuccess) return err;
  // a whole number of clusters along M; the CTAs past the last tile idle
  const unsigned tiles = (unsigned)((a.m + BM - 1) / BM);
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = onepass_launch<WGS>(
      dim3((tiles + kCluster - 1) / kCluster * kCluster, blocks_n), c, stream,
      &cluster);
  err = cudaLaunchKernelEx(&cfg, gru_tf32_onepass<WGS, ZR>, a, c.stages);
  return err != cudaSuccess ? err : cudaGetLastError();
}

// CTAs of gru_tf32_onepass<WGS, true> the device holds at once
template <int WGS>
cudaError_t resident_ctas(const OnePass& c, int device, int limit, int* ctas) {
  cudaError_t err = allow_onepass_smem<WGS, true>(device, limit);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = onepass_launch<WGS>(dim3(kCluster), c,
                                                     nullptr, &cluster);
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, gru_tf32_onepass<WGS, true>,
                                       &cfg);
  *ctas = clusters * kCluster;
  return err;
}

template <int WGS>
int launch_onepass(Args zr, Args q, const OnePass& c, int device, int limit,
                   cudaStream_t stream) {
  zr.gap = q.gap = c.gap;
  cudaError_t err = launch_onepass_kernel<WGS, true>(zr, 2 * kC / kBN, c,
                                                     device, limit, stream);
  if (err == cudaSuccess)
    err = launch_onepass_kernel<WGS, false>(q, kC / kBN, c, device, limit,
                                            stream);
  return (int)err;
}

int launch_one_pass(Args zr, Args q, int stride, int device, int limit,
                    cudaStream_t stream) {
  const OnePass c = onepass_config(stride, limit);
  if (c.wgs == 2) return launch_onepass<2>(zr, q, c, device, limit, stream);
  if (c.wgs == 1) return launch_onepass<1>(zr, q, c, device, limit, stream);
  return (int)cudaErrorInvalidValue;
}

cudaError_t device_limit(int* device, int* limit) {
  cudaError_t err = cudaGetDevice(device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, *device);
  return err;
}

}  // namespace

extern "C" {

// h, motion, q_term, z, rh, out: (B, H, W, 128); zr_term: (B, H, W, 256);
// w_zr: (2, 5, 8, 256, 32); w_q: (2, 5, 8, 128, 32) (ops/gru.py::
// pack_direction); all contiguous float32. axis_h: 0 for the 1x5 pass (taps
// along W), 1 for the 5x1 pass (along H). passes: 3 (3xTF32) or 1. z and rh
// are scratch the caller allocates.
int vft_gru_direction_passes(const void* h, const void* motion,
                             const void* w_zr, const void* w_q,
                             const void* zr_term, const void* q_term, void* z,
                             void* rh, void* out, int batch, int height,
                             int width, int axis_h, int passes, void* stream) {
  const long long m = (long long)batch * height * width;
  if (passes != 1 && passes != 3) return (int)cudaErrorInvalidValue;
  if (m <= 0) return (int)cudaSuccess;
  if (m * kIn >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const int stride = axis_h ? width : 1;
  Args zr{static_cast<const float*>(h), static_cast<const float*>(motion),
          static_cast<const float*>(w_zr), static_cast<const float*>(zr_term),
          static_cast<const float*>(h), nullptr, static_cast<float*>(z),
          static_cast<float*>(rh), (int)m, height, width, axis_h, 2 * kC,
          stride, 0};
  Args q{static_cast<const float*>(rh), static_cast<const float*>(motion),
         static_cast<const float*>(w_q), static_cast<const float*>(q_term),
         static_cast<const float*>(h), static_cast<const float*>(z),
         static_cast<float*>(out), nullptr, (int)m, height, width, axis_h, kC,
         stride, 0};
  int device = 0, limit = 0;
  cudaError_t err = device_limit(&device, &limit);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 128-pixel blocks where a slice's staged rows fit, else 64
  const bool wide = smem_bytes(128, stride < 128 ? stride : 128) <= (size_t)limit;
  if (passes == 1) return launch_one_pass(zr, q, stride, device, limit, s);
  return wide ? launch<2, 3>(zr, q, device, limit, s)
              : launch<1, 3>(zr, q, device, limit, s);
}

// How the one-pass kernel runs a grid of this width on the current device:
// CTAs per cluster, weight ring stages, pixels per CTA, shared memory bytes
// per CTA and the CTAs the device holds at once. Returns a CUDA error code.
int vft_gru_one_pass_config(int width, int axis_h, int* cluster, int* stages,
                            int* bm, int* smem, int* resident) {
  int device = 0, limit = 0;
  cudaError_t err = device_limit(&device, &limit);
  if (err != cudaSuccess) return (int)err;
  const OnePass c = onepass_config(axis_h ? width : 1, limit);
  if (!c.wgs) return (int)cudaErrorInvalidValue;
  *cluster = kCluster;
  *stages = c.stages;
  *bm = 64 * c.wgs;
  *smem = (int)c.smem;
  return (int)(c.wgs == 2 ? resident_ctas<2>(c, device, limit, resident)
                          : resident_ctas<1>(c, device, limit, resident));
}

// The same in 3xTF32 (the entry point before the pass count existed).
int vft_gru_direction(const void* h, const void* motion, const void* w_zr,
                      const void* w_q, const void* zr_term, const void* q_term,
                      void* z, void* rh, void* out, int batch, int height,
                      int width, int axis_h, void* stream) {
  return vft_gru_direction_passes(h, motion, w_zr, w_q, zr_term, q_term, z,
                                  rh, out, batch, height, width, axis_h, 3,
                                  stream);
}

}  // extern "C"
