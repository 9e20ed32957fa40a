// A convolution in 3xTF32 for Hopper (sm_90a): implicit GEMM on wgmma,
// channels-last.
//
// Replaces no Pallas kernel. On the TPU the JAX package leaves every
// convolution of the fused RAFT -> I3D step and of the RAFT step to XLA, and
// under precision=mixed and high runs them with the ambient matmul precision
// 'high': three bf16 products per fp32 product
// (video_features_tpu/extract/base.py:177, ops/precision.py:34-44). cuDNN and
// cuBLAS have no three-pass mode, so on the card those lanes get this kernel
// for every convolution of the i3d, raft, r21d, s3d, resnet and vggish
// families (ops/conv_tf32x3.py, ops/nn.py::conv_route). It is the Hopper form of the
// TPU's three passes, with the arithmetic of csrc/gru_direction.cu: each
// operand x splits into hi = tf32(x) and lo = tf32(x - hi), both rounded to
// nearest (cvt.rna.tf32.f32), and every 32-K chunk accumulates lo*hi +
// hi*lo + hi*hi; the dropped lo*lo term is below fp32's rounding.
//
// What it computes: y = conv(x, w) + bias with x (N, T, H, W, C) and y (N,
// OT, OH, OW, O) channels-last (2-D convolutions are T = KT = 1), each
// spatial axis with its own stride and its own zero padding per edge (I3D's
// TF-SAME pads are asymmetric), groups G >= 1 (ResNeXt's 3x3), fp32 in and
// out. C is a multiple of 4: the wrapper pads an input of 2, 3, 45 or 921
// channels to the next multiple of 4, one copy.
//
// Grouped convolutions (G > 1, IG = C / G input and OG = O / G output
// channels per group): an output tile covers whole groups (BN a multiple of
// OG) or lies inside one (OG a multiple of BN), and its K loop reads only
// the CIN input channels of the groups it covers, from channel
// (tile * BN / OG) * IG on. Its packed weight is that tile's block
// diagonal, zeros off the blocks: ResNeXt's 4 channels per group at the
// narrowest tile of 8 do 2x the products, 8 to 64 channels per group none
// wasted. Never one dense (O, C) weight across the groups (G times the
// products).
//
// What bounds it on the H100: operations, at the path's shapes. The
// heaviest convolution of RAFT's refinement iteration at the fused batch-8
// size (motion encoder convc2: 3x3, 256 -> 192, M = 176,128 output pixels)
// does 2 * M * 192 * 2304 = 1.56e11 flops against ~0.3 GB of input and
// output: 3 x 1.56e11 / 495 TFLOP/s = 0.94 ms at the tensor cores' TF32
// rate, 0.09 ms at 3.35 TB/s. Only the flow head's 256 -> 2 is bound by
// bytes.
//
// Design (the shape of csrc/gru_direction.cu's 3xTF32 kernel): a block
// computes BM = 64 * WGS output pixels x BN output channels with WGS
// warpgroups; M = pixels, N = output channels, K = taps x channels.
//
//   * K order: taps (kt, kh, kw row-major) and, in each tap, the tile's CIN
//     input channels (C padded to 4 where G = 1). A 32-K chunk is eight
//     4-channel groups,
//     each inside one tap, and may span taps: one rule for every C, where
//     the mma.sync design below copied narrow inputs 4 bytes at a time and
//     padded wide ones to 32 per tap (up to 2x wasted products at I3D's C =
//     16, 24, 48, 112 and 144).
//   * Weights (B): wgmma's tf32 form reads only K-major B, so
//     ops/conv_tf32x3.py::pack_weight packs them once as (tiles, chunks,
//     hi | lo, BN, 32): split into TF32 parts, each row's 32 K values in the
//     fragment order of ops/gru.py::K_ORDER, in the 128-byte swizzle the
//     descriptor names. A chunk's (hi | lo) tile is 2 * BN * 128 bytes
//     contiguous: one bulk TMA copy (cp.async.bulk) by thread 0, completing
//     on the stage's "full" mbarrier. No block splits a weight again.
//   * Activations (A): each chunk's BM rows x 32 K (one output pixel's
//     input at up to 8 taps), copied 16 bytes (4 channels of one tap) at a
//     time by cp.async from every thread (4 copies each), zero-filled where
//     a tap leaves the input, the row passes the last pixel or the group
//     passes K; each thread arrives on the same "full" mbarrier once its
//     copies have landed (cp.async.mbarrier.arrive.noinc). Rows are 36
//     floats apart, so a fragment's lanes hit distinct banks. Each row's
//     first tap is a table in shared memory (its input offset in 32 bits,
//     the entry point refusing inputs of 2^31 floats or more, and its
//     position), so a copy is a few integer operations.
//   * A ring of 2..kMaxStages stages of (weights | rows), as many as the
//     block's shared memory holds; chunk q + stages - 2 is staged while
//     chunk q's products run, into the stage chunk q - 2 freed once every
//     warp has arrived on its "empty" mbarrier, so no warp waits for a warp
//     still in chunk q - 1 and the warpgroups drift apart: one flushes
//     while the other queues its products. No block-wide barrier after
//     the set-up.
//   * Products: each warpgroup of 64 rows queues
//     wgmma.mma_async.m64n{BN}k8.f32.tf32.tf32 with A from registers (each
//     thread loads 8 contiguous floats of its two rows, two 16-byte loads a
//     row, and splits hi/lo there) and B from the stage's descriptors. A
//     chunk's 12 products (4 k8 steps x 3) go into a fresh accumulator
//     (part), which is added to the running sum (acc) in fp32 once the
//     group is done: the tensor cores' accumulator truncates, and summing a
//     long K in it measured ~2e-5 against float64 in csrc/gru_direction.cu,
//     ~1e-6 with the flush. The next chunk's fragments load while the
//     tensor cores run this one's. Empty asm statements that name the sums
//     and fragments (fence_regs) keep every read of a sum and every reuse of
//     a fragment's registers after the wait that frees them, so ptxas need
//     not serialise the products.
//   * Tiles (ops/conv_tf32x3.py::conv_plan): BN one of the template widths,
//     the output channels cut into equal tiles of the least padding (2 ->
//     8, 192 -> 2 x 96, 576 -> 6 x 96), so narrow heads do not pay for 128
//     columns; BM = 128 (two warpgroups, one block per SM) or 64 (one, two
//     blocks per SM) where 128 would leave SMs without a block. acc and
//     part hold BN fp32 registers a thread, at most 128: with no producer
//     warp a block of 256 threads may take 255 registers a thread, and
//     none spills (a producer warp or warpgroup beside the consumers made
//     ptxas allocate for 384 threads, 168 registers, and BN = 128 spilled).
//   * Epilogue: bias added, each output written once, channels-last.
//
// What it measured (tools/conv_tf32x3_variants.py, NVIDIA H100 80GB HBM3,
// 700 W; PERF.md): the row copies hold it back. At convc2 (fused size) the
// kernel took 2.06 ms; without the row copies 1.43, the product floor being
// 1.40; without the weight tiles 2.05; the copies alone 1.51. Each input
// pixel is copied once per tap and output tile (nine times for a 3x3
// convolution), and the copies and the products overlap only in part.
// Tried and dropped: sharing each weight tile between
// the two blocks of a cluster by multicast (no faster), one arrival per
// warp on the "full" barrier instead of one per thread (slower everywhere),
// a producer warp or warpgroup (its launch bound capped the consumers at
// 168 registers), and a slab mode for 2-D stride-1 convolutions that staged
// each 32-channel slice's input rows once for all taps (a quarter of the
// row copies, but its product floor rose ~35% for reasons not found, so it
// lost on every tile wider than the flow head's 8 columns).
//
// No split-K and no atomics: every output is written once by one thread, so
// results are deterministic. Every mbarrier wait is bounded: a barrier that
// never completes traps (a launch error) instead of hanging the card.
//
// The earlier design stays beside it as a yardstick (conv_tf32x3_mma,
// vft_conv_tf32x3_mma; ops/conv_tf32x3.py::conv_tf32x3_mma), on no path:
// mma.sync.m16n8k8 with a two-stage cp.async ring and a block-wide barrier
// per chunk, weights split again by every block that reads them, a 4-byte
// gather for C % 4 != 0 and output columns padded to 128.
//
// The entry points launch on the given stream, do not synchronize, and
// return a CUDA error code (0 on success) so the caller can raise on a
// refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// TF32 rounding to nearest, ties away from zero: cvt.rna.tf32.f32 for
// finite x, in two integer operations (ops/gru.py::tf32_round on the host).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

// Raise a kernel's dynamic shared memory limit once per device ordinal (set:
// the kernel's own table). The runtime keeps a function's attributes per
// device context: a flag set once per process would leave a second card at
// the 48 KB default, where the launch fails with cudaErrorInvalidValue.
constexpr int kMaxDevices = 64;

cudaError_t raise_smem(const void* kernel, std::atomic<int>* set, int device,
                       int bytes) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set[device].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set[device].store(bytes, std::memory_order_release);
  return err;
}

// ---------------------------------------------------------------------------
// The wgmma kernel: conv_tf32x3_wgmma<WGS, BN>.

constexpr int kBK = 32;                  // K per chunk
constexpr int kLda = kBK + 4;            // floats per staged activation row
constexpr int kMaxStages = 8;
constexpr uint32_t kSpinLimit = 1u << 26;
// a row past the last output pixel: its first tap's position fails every
// bounds check
constexpr int kNoRow = -(1 << 30);

struct Conv {
  const float* x;      // (N, T, H, W, C), C a multiple of 4, < 2^31 floats
  const float* w;      // pack_weight's (tiles, chunks, 2, BN, 32)
  const float* bias;   // (O) or null
  float* y;            // (N, OT, OH, OW, O)
  long long m;         // output pixels: N * OT * OH * OW
  int t, h, w_, c;     // input extent
  int ot, oh, ow, o;   // output extent
  int kt, kh, kw;      // taps per axis
  int st, sh, sw;      // strides
  int pt, ph, pw;      // low-side zero padding
  int cin;             // input channels a tile reads per tap, a multiple of 4
  int ig, og;          // input and output channels per convolution group
  int quads;           // 4-channel groups of K that hold data: taps * CIN / 4
  int chunks;          // 32-K chunks
  int stages;          // ring depth, 2..kMaxStages
};

template <int WGS, int BN>
struct Wg {
  static constexpr int kBM = 64 * WGS;
  static constexpr int kThreads = 128 * WGS;
  static constexpr int kWBytes = 2 * BN * kBK * 4;       // hi | lo tile
  static constexpr int kABytes = kBM * kLda * 4;
  static constexpr int kStageBytes = kWBytes + kABytes;
  // copies of 16 bytes per thread per chunk: BM rows x 8 groups
  static constexpr int kCopies = kBM * 8 / kThreads;
  // one warpgroup: two blocks share an SM (255 registers a thread either
  // way)
  static constexpr int kBlocksPerSm = 3 - WGS;
  // alignment slack, the row table, the mbarriers
  static constexpr int kFixedBytes = 1024 + kBM * 16 + 2 * kMaxStages * 8;
  static constexpr size_t smem(int stages) {
    return (size_t)kFixedBytes + (size_t)stages * kStageBytes;
  }
};

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
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

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(bar) : "memory");
}

// bytes from src to dst by one bulk TMA copy, completing on bar, which
// expects them
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// K-major B in the 128-byte swizzle: rows of 128 bytes (32 tf32 along K),
// 8-row groups 1024 bytes apart (SBO); a k8 step advances 32 bytes.
__device__ __forceinline__ uint64_t b_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4)
       | ((uint64_t)1 << 16)                       // LBO (unused when swizzled)
       | ((uint64_t)(1024 >> 4) << 32)             // SBO
       | ((uint64_t)1 << 62);                      // 128-byte swizzle
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

// D (+)= A * B for one warpgroup: m64 n{N} k8, tf32 in, fp32 accumulated;
// A from registers, B from a shared-memory descriptor; scale_d = 0 ignores
// the input D. The accumulator holds N / 2 floats per thread.
template <int N>
__device__ __forceinline__ void wgmma_tf32(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);

template <>
__device__ __forceinline__ void wgmma_tf32<8>(float (&d)[4], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<16>(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<24>(float (&d)[12], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11"
      "}, {%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<32>(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<48>(float (&d)[24], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %29, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n48k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23"
      "}, {%24, %25, %26, %27}, %28, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<64>(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<72>(float (&d)[36], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %41, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n72k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35"
      "}, {%36, %37, %38, %39}, %40, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<80>(float (&d)[40], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<96>(float (&d)[48], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47"
      "}, {%48, %49, %50, %51}, %52, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<104>(float (&d)[52], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<112>(float (&d)[56], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64], const uint32_t (&a)[4],
                                                uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}


// WGS: warpgroups (BM = 64 * WGS output pixels per block); BN: output
// channels per block, one of the template widths.
template <int WGS, int BN>
__global__ void __launch_bounds__(Wg<WGS, BN>::kThreads,
                                  Wg<WGS, BN>::kBlocksPerSm)
conv_tf32x3_wgmma(const Conv g) {
  using T = Wg<WGS, BN>;
  constexpr int BM = T::kBM;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled weight tiles want 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  const uint32_t wstage = smem_addr(base);                  // stages x kWBytes
  float* astage = reinterpret_cast<float*>(base + (size_t)g.stages * T::kWBytes);
  // rows[r]: output pixel m0 + r's first tap: its input offset (floats, at
  // channel 0) and input position (t, h, w); kNoRow past the last pixel
  int4* rows = reinterpret_cast<int4*>(base + (size_t)g.stages * T::kStageBytes);
  // full[s]: stage s's weights and rows arrived; empty[s]: every warp is
  // done with them
  uint64_t* full = reinterpret_cast<uint64_t*>(rows + BM);
  uint64_t* empty = full + kMaxStages;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const long long m0 = (long long)blockIdx.x * BM;
  const int tile = blockIdx.y;

  for (int r = tid; r < BM; r += T::kThreads) {
    const long long m = m0 + r;
    int4 row = make_int4(0, kNoRow, kNoRow, kNoRow);
    if (m < g.m) {                       // m < 2^31: the entry point checks
      int q = (int)m;
      const int ow = q % g.ow;
      q /= g.ow;
      const int oh = q % g.oh;
      q /= g.oh;
      const int ot = q % g.ot;
      q /= g.ot;
      const int t0 = ot * g.st - g.pt, h0 = oh * g.sh - g.ph,
                w0 = ow * g.sw - g.pw;
      // may point before the tensor (a padded edge); only in-bounds taps
      // are ever read
      row = make_int4(((q * g.t + t0) * g.h + h0) * g.w_ * g.c + w0 * g.c, t0,
                      h0, w0);
    }
    rows[r] = row;
  }
  if (tid == 0) {
    for (int i = 0; i < g.stages; ++i) {
      // every thread's copies and thread 0's expect_tx
      mbar_init(smem_addr(&full[i]), T::kThreads + 1);
      mbar_init(smem_addr(&empty[i]), 4 * WGS);         // warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Chunk q into stage s: its (hi | lo) weight tile by one bulk copy
  // (thread 0) and its rows by 16-byte cp.async, this
  // thread's 4-channel group j for rows tid / 8 + i * kThreads / 8,
  // zero-filled outside the input and past K; every thread arrives on
  // full[s] once its copies have landed.
  const int j = tid % 8;
  const int cg = g.cin / 4;              // 4-channel groups per tap
  const int khw = g.kh * g.kw;
  // the tile's first input channel: its first convolution group's (0 for
  // G = 1, where every tile starts below OG = O)
  const int cbase = (int)((long long)tile * BN / g.og) * g.ig;
  const float* wsrc = g.w + (size_t)tile * g.chunks * (T::kWBytes / 4);
  const uint32_t adst = smem_addr(astage) + (tid / 8) * kLda * 4 + 16 * j;
  auto stage_chunk = [&](int q, int s) {
    const uint32_t bar = smem_addr(&full[s]);
    if (tid == 0)
      bulk_load(wstage + s * T::kWBytes, wsrc + (size_t)q * (T::kWBytes / 4),
                T::kWBytes, bar);
    const int grp = q * 8 + j;
    const bool kin = grp < g.quads;
    const int tap = kin ? grp / cg : 0;
    const int dt = tap / khw, rem = tap - dt * khw;
    const int dh = rem / g.kw, dw = rem - dh * g.kw;
    const int off = ((dt * g.h + dh) * g.w_ + dw) * g.c + cbase
                    + (grp - tap * cg) * 4;
    const uint32_t dst = adst + s * T::kABytes;
#pragma unroll
    for (int i = 0; i < T::kCopies; ++i) {
      const int4 rw = rows[tid / 8 + i * (T::kThreads / 8)];
      const bool ok = kin && (unsigned)(rw.y + dt) < (unsigned)g.t
                      && (unsigned)(rw.z + dh) < (unsigned)g.h
                      && (unsigned)(rw.w + dw) < (unsigned)g.w_;
      cp_async16(dst + i * (T::kThreads / 8) * kLda * 4,
                 g.x + (ok ? rw.x + off : 0), ok);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
  };
  // chunks are staged `ahead` chunks ahead, each into the stage that chunk
  // q + ahead - stages freed: with ahead = stages - 2 that is chunk q - 2,
  // so no warp waits for a warp still in chunk q - 1 and the warpgroups
  // drift apart (one flushes while the other queues its products)
  const int ahead = g.stages > 2 ? g.stages - 2 : 1;
  const int first = ahead < g.chunks ? ahead : g.chunks;
  for (int q = 0; q < first; ++q) stage_chunk(q, q);

  // this thread's rows: fragment rows g and g + 8 of its warp
  const int r0 = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + lane / 4;
  const float* arow = astage + r0 * kLda + 8 * (lane % 4);
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  // a chunk's 8 contiguous floats of each row (the packed weights' K order
  // puts k8 step k's fragment columns t and t + 4 at channels 8t + 2k and
  // 8t + 2k + 1), then split into hi and lo
  float4 x[4];
  uint32_t hi[4][4], lo[4][4];
  auto load_rows = [&](int s) {
    const float* r = arow + (size_t)s * (T::kABytes / 4);
    x[0] = *reinterpret_cast<const float4*>(r);
    x[1] = *reinterpret_cast<const float4*>(r + 4);
    x[2] = *reinterpret_cast<const float4*>(r + 8 * kLda);
    x[3] = *reinterpret_cast<const float4*>(r + 8 * kLda + 4);
  };
  int s = 0;
  mbar_wait(smem_addr(&full[0]), 0);
  load_rows(0);
#pragma unroll 1
  for (int q = 0; q < g.chunks; ++q) {
    // fragment order: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
    const float v[4][4] = {{x[0].x, x[2].x, x[0].y, x[2].y},
                           {x[0].z, x[2].z, x[0].w, x[2].w},
                           {x[1].x, x[3].x, x[1].y, x[3].y},
                           {x[1].z, x[3].z, x[1].w, x[3].w}};
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) split(v[k][e], hi[k][e], lo[k][e]);
    const uint32_t bhi = wstage + s * T::kWBytes;
    const uint32_t blo = bhi + BN * kBK * 4;
    fence_regs(part);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_tf32<BN>(part, lo[k], b_desc(bhi + 32 * k), k > 0);    // afresh
      wgmma_tf32<BN>(part, hi[k], b_desc(blo + 32 * k), 1);
      wgmma_tf32<BN>(part, hi[k], b_desc(bhi + 32 * k), 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    fence_regs(part);
    // while the tensor cores run: chunk q + ahead, into its stage once
    // every warp has released that stage's last chunk, q + ahead - stages
    if (q + ahead < g.chunks) {
      const int c = q + ahead;
      const int sa = c % g.stages;
      if (c >= g.stages)
        mbar_wait(smem_addr(&empty[sa]), (c / g.stages - 1) & 1);
      stage_chunk(c, sa);
    }
    // and the next chunk's fragments (past the last chunk a stale stage is
    // read and never used, so that no load sits in a branch)
    const int sn = s + 1 == g.stages ? 0 : s + 1;
    if (q + 1 < g.chunks)
      mbar_wait(smem_addr(&full[sn]), ((q + 1) / g.stages) & 1);
    load_rows(sn);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(part);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fence_regs(hi[k]);
      fence_regs(lo[k]);
    }
    // this warp is done with stage s
    __syncwarp();
    if (lane == 0) mbar_arrive(smem_addr(&empty[s]));
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    s = sn;
  }

  // Epilogue: acc[4j + 2i + e] is pixel m0 + r0 + 8i, channel 8j + 2t + e
  // of this block's BN (t = lane % 4).
  const bool pairs = g.o % 2 == 0;       // n even: an aligned float2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long m = m0 + r0 + 8 * i;
    if (m >= g.m) continue;
    float* yrow = g.y + m * g.o;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int n = tile * BN + 8 * jn + 2 * (lane % 4);
      if (n >= g.o) continue;
      const float v0 = acc[4 * jn + 2 * i]
                       + (g.bias != nullptr ? __ldg(g.bias + n) : 0.f);
      if (n + 1 < g.o) {
        const float v1 = acc[4 * jn + 2 * i + 1]
                         + (g.bias != nullptr ? __ldg(g.bias + n + 1) : 0.f);
        if (pairs) {
          *reinterpret_cast<float2*>(yrow + n) = make_float2(v0, v1);
        } else {
          yrow[n] = v0;
          yrow[n + 1] = v1;
        }
      } else {
        yrow[n] = v0;
      }
    }
  }
}

// The ring's depth for an instantiation on this device: as many stages as
// the block's share of shared memory holds, 2..kMaxStages (0: not even 2).
template <int WGS, int BN>
int ring_stages(int optin, int per_sm) {
  using T = Wg<WGS, BN>;
  // a block's share: the opt-in maximum, or half the SM less the 1 KB the
  // runtime reserves per block where two blocks share it
  long long budget = optin;
  if (T::kBlocksPerSm == 2 && per_sm / 2 - 1024 < budget)
    budget = per_sm / 2 - 1024;
  const long long fit = (budget - T::kFixedBytes) / T::kStageBytes;
  if (fit < 2) return 0;
  return fit < kMaxStages ? (int)fit : kMaxStages;
}

template <int WGS, int BN>
int launch_wgmma(Conv g, int tiles, int device, int optin, int per_sm,
                 cudaStream_t stream) {
  using T = Wg<WGS, BN>;
  static std::atomic<int> set[kMaxDevices];
  g.stages = ring_stages<WGS, BN>(optin, per_sm);
  if (!g.stages) return (int)cudaErrorInvalidValue;
  const size_t smem = T::smem(g.stages);
  cudaError_t err = raise_smem(
      reinterpret_cast<const void*>(conv_tf32x3_wgmma<WGS, BN>), set, device,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long blocks_m = (g.m + T::kBM - 1) / T::kBM;
  if (blocks_m >= (1LL << 31) || tiles > 65535) return (int)cudaErrorInvalidValue;
  conv_tf32x3_wgmma<WGS, BN>
      <<<dim3((unsigned)blocks_m, (unsigned)tiles), T::kThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

int launch_tile(const Conv& g, int bm, int bn, int tiles, int device,
                int optin, int per_sm, cudaStream_t stream) {
  // the template widths: ops/conv_tf32x3.py::TILE_WIDTHS
#define VFT_CONV_WIDTH(W)                                                    \
  case W:                                                                    \
    return bm == 128                                                         \
        ? launch_wgmma<2, W>(g, tiles, device, optin, per_sm, stream)        \
        : launch_wgmma<1, W>(g, tiles, device, optin, per_sm, stream);
  switch (bn) {
    VFT_CONV_WIDTH(8)
    VFT_CONV_WIDTH(16)
    VFT_CONV_WIDTH(24)
    VFT_CONV_WIDTH(32)
    VFT_CONV_WIDTH(48)
    VFT_CONV_WIDTH(64)
    VFT_CONV_WIDTH(72)
    VFT_CONV_WIDTH(80)
    VFT_CONV_WIDTH(96)
    VFT_CONV_WIDTH(104)
    VFT_CONV_WIDTH(112)
    VFT_CONV_WIDTH(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VFT_CONV_WIDTH
}

// ---------------------------------------------------------------------------
// The mma.sync yardstick: conv_tf32x3_mma<BN, VEC>, on no path (see the
// note). A block computes 128 output pixels x BN (16, 64 or 128) output
// channels with 4 x 2 (or 4 x 1) warps on mma.sync.aligned.m16n8k8 TF32; K
// runs in chunks of 32 staged by cp.async in two buffers; every thread
// splits hi and lo of its A and B fragments in registers. Its weights are
// ops/conv_tf32x3.py::pack_weight_mma's (K_pad, O_pad) fp32 matrix: taps,
// then channels padded to 32 per tap where C % 4 == 0 ("vector" mode,
// 16-byte copies), unpadded where not ("gather" mode, 4-byte copies).

namespace mma {

constexpr int kBM = 128;                 // output pixels per block
constexpr int kBK = 32;                  // K per staged chunk
constexpr int kLda = kBK + 4;            // floats per staged A row
constexpr int kStages = 2;
constexpr int kOPadMultiple = 128;       // ops/conv_tf32x3.py::MMA_O_PAD

struct Geometry {
  const float* x;      // (N, T, H, W, C)
  const float* w;      // packed (k_pad, o_pad)
  const float* bias;   // (O) or null
  float* y;            // (N, OT, OH, OW, O)
  long long m;         // output pixels: N * OT * OH * OW
  int t, h, w_, c;     // input extent
  int ot, oh, ow, o;   // output extent
  int kt, kh, kw;      // taps per axis
  int st, sh, sw;      // strides
  int pt, ph, pw;      // low-side zero padding
  int k_real;          // taps * C (gather mode's K before the chunk pad)
  int c_pad;           // K per tap in vector mode: C rounded up to 32
  int k_pad, o_pad;    // packed weight rows and columns
};

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int BN>
struct Tile {
  static constexpr int kWarpsN = BN >= 64 ? 2 : 1;
  static constexpr int kThreads = 128 * kWarpsN;     // 4 warps along M
  static constexpr int kWN = BN / (8 * kWarpsN);     // n8 tiles per warp
  static constexpr int kWM = 2;                      // m16 tiles per warp
  static constexpr int kLdb = BN + 8;                // floats per B row
  static constexpr size_t kSmem =
      sizeof(float) * kStages * (kBM * kLda + kBK * kLdb) + sizeof(int) * 4 * kBM;
};

// Stage chunk q of A and B into buffer `stage` (cp.async, not waited for).
template <int BN, bool VEC>
__device__ __forceinline__ void load_chunk(const Geometry& g, int q, int n0,
                                           float* as, float* bs,
                                           const int* rows) {
  using T = Tile<BN>;
  const int tid = threadIdx.x;
  const int khw = g.kh * g.kw;
  if (VEC) {
    const int per_tap = g.c_pad / kBK;
    const int tap = q / per_tap;
    const int c0 = (q - tap * per_tap) * kBK;
    const int dt = tap / khw, rem = tap - dt * khw;
    const int dh = rem / g.kw, dw = rem - dh * g.kw;
    for (int i = tid; i < kBM * (kBK / 4); i += T::kThreads) {
      const int r = i / (kBK / 4), j = i - r * (kBK / 4);
      const int c = c0 + 4 * j;
      const int b = rows[r];
      const int it = rows[kBM + r] + dt, ih = rows[2 * kBM + r] + dh,
                iw = rows[3 * kBM + r] + dw;
      const bool ok = b >= 0 && c < g.c && (unsigned)it < (unsigned)g.t
                      && (unsigned)ih < (unsigned)g.h
                      && (unsigned)iw < (unsigned)g.w_;
      const float* src = g.x;
      if (ok)
        src = g.x + ((((long long)b * g.t + it) * g.h + ih) * (long long)g.w_
                     + iw) * g.c + c;
      cp_async16(smem_addr(as + r * kLda + 4 * j), src, ok);
    }
  } else {
    for (int i = tid; i < kBM * kBK; i += T::kThreads) {
      const int r = i / kBK, kk = i - r * kBK;
      const int k = q * kBK + kk;
      const int b = rows[r];
      bool ok = false;
      const float* src = g.x;
      if (b >= 0 && k < g.k_real) {
        const int tap = k / g.c, c = k - tap * g.c;
        const int dt = tap / khw, rem = tap - dt * khw;
        const int dh = rem / g.kw, dw = rem - dh * g.kw;
        const int it = rows[kBM + r] + dt, ih = rows[2 * kBM + r] + dh,
                  iw = rows[3 * kBM + r] + dw;
        ok = (unsigned)it < (unsigned)g.t && (unsigned)ih < (unsigned)g.h
             && (unsigned)iw < (unsigned)g.w_;
        if (ok)
          src = g.x + ((((long long)b * g.t + it) * g.h + ih) * (long long)g.w_
                       + iw) * g.c + c;
      }
      cp_async4(smem_addr(as + r * kLda + kk), src, ok);
    }
  }
  const float* wsrc = g.w + (long long)q * kBK * g.o_pad + n0;
  for (int i = tid; i < kBK * (BN / 4); i += T::kThreads) {
    const int r = i / (BN / 4), j = i - r * (BN / 4);
    cp_async16(smem_addr(bs + r * T::kLdb + 4 * j),
               wsrc + (long long)r * g.o_pad + 4 * j, true);
  }
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(Tile<BN>::kThreads)
conv_tf32x3_mma(const Geometry g) {
  using T = Tile<BN>;
  extern __shared__ __align__(16) float smem[];
  float* as = smem;                                   // [kStages][kBM][kLda]
  float* bs = as + kStages * kBM * kLda;              // [kStages][kBK][kLdb]
  int* rows = reinterpret_cast<int*>(bs + kStages * kBK * T::kLdb);
  // rows: [batch | t0 | h0 | w0][kBM], batch -1 past the last pixel

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int warp_m = warp & 3, warp_n = warp >> 2;
  const int grp = lane >> 2, tig = lane & 3;
  const long long m0 = (long long)blockIdx.x * kBM;
  const int n0 = blockIdx.y * BN;

  for (int r = tid; r < kBM; r += T::kThreads) {
    const long long m = m0 + r;
    int b = -1, t0 = 0, h0 = 0, w0 = 0;
    if (m < g.m) {
      long long q = m / g.ow;
      const int ow = (int)(m - q * g.ow);
      const long long q2 = q / g.oh;
      const int oh = (int)(q - q2 * g.oh);
      const long long q3 = q2 / g.ot;
      const int ot = (int)(q2 - q3 * g.ot);
      b = (int)q3;
      t0 = ot * g.st - g.pt;
      h0 = oh * g.sh - g.ph;
      w0 = ow * g.sw - g.pw;
    }
    rows[r] = b;
    rows[kBM + r] = t0;
    rows[2 * kBM + r] = h0;
    rows[3 * kBM + r] = w0;
  }
  __syncthreads();

  float acc[T::kWM][T::kWN][4];
#pragma unroll
  for (int i = 0; i < T::kWM; ++i)
#pragma unroll
    for (int j = 0; j < T::kWN; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  const int chunks = g.k_pad / kBK;
  load_chunk<BN, VEC>(g, 0, n0, as, bs, rows);
  cp_async_commit();
  for (int q = 0; q < chunks; ++q) {
    const int cur = q & 1;
    if (q + 1 < chunks)
      load_chunk<BN, VEC>(g, q + 1, n0, as + (cur ^ 1) * kBM * kLda,
                          bs + (cur ^ 1) * kBK * T::kLdb, rows);
    cp_async_commit();                 // an empty group on the last chunk
    cp_async_wait<1>();                // chunk q has landed
    __syncthreads();

    const float* a = as + cur * kBM * kLda + (warp_m * 32 + grp) * kLda + tig;
    const float* bt = bs + cur * kBK * T::kLdb + tig * T::kLdb
                      + warp_n * (T::kWN * 8) + grp;
    float part[T::kWM][T::kWN][4];
#pragma unroll
    for (int i = 0; i < T::kWM; ++i)
#pragma unroll
      for (int j = 0; j < T::kWN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 8) {
      uint32_t ahi[T::kWM][4], alo[T::kWM][4];
#pragma unroll
      for (int i = 0; i < T::kWM; ++i) {
        const float* ai = a + i * 16 * kLda + ks;
        split(ai[0], ahi[i][0], alo[i][0]);
        split(ai[8 * kLda], ahi[i][1], alo[i][1]);
        split(ai[4], ahi[i][2], alo[i][2]);
        split(ai[8 * kLda + 4], ahi[i][3], alo[i][3]);
      }
#pragma unroll
      for (int j = 0; j < T::kWN; ++j) {
        uint32_t bhi0, blo0, bhi1, blo1;
        split(bt[ks * T::kLdb + j * 8], bhi0, blo0);
        split(bt[(ks + 4) * T::kLdb + j * 8], bhi1, blo1);
#pragma unroll
        for (int i = 0; i < T::kWM; ++i) {
          mma_tf32(part[i][j], alo[i], bhi0, bhi1);
          mma_tf32(part[i][j], ahi[i], blo0, blo1);
          mma_tf32(part[i][j], ahi[i], bhi0, bhi1);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < T::kWM; ++i)
#pragma unroll
      for (int j = 0; j < T::kWN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
    __syncthreads();                   // buffer cur is refilled next
  }

#pragma unroll
  for (int i = 0; i < T::kWM; ++i) {
#pragma unroll
    for (int j = 0; j < T::kWN; ++j) {
      const int col = n0 + warp_n * (T::kWN * 8) + j * 8 + 2 * tig;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp_m * 32 + i * 16 + grp + 8 * half;
        if (m >= g.m) continue;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = col + e;
          if (n < g.o)
            g.y[m * g.o + n] = acc[i][j][2 * half + e]
                               + (g.bias != nullptr ? g.bias[n] : 0.0f);
        }
      }
    }
  }
}

template <int BN, bool VEC>
cudaError_t allow_smem(int device) {
  static std::atomic<int> set[kMaxDevices];
  return raise_smem(reinterpret_cast<const void*>(conv_tf32x3_mma<BN, VEC>),
                    set, device, (int)Tile<BN>::kSmem);
}

template <int BN, bool VEC>
int launch(const Geometry& g, int device, cudaStream_t stream) {
  cudaError_t err = allow_smem<BN, VEC>(device);
  if (err != cudaSuccess) return (int)err;
  const long long blocks_m = (g.m + kBM - 1) / kBM;
  if (blocks_m >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks_m, (unsigned)((g.o + BN - 1) / BN));
  conv_tf32x3_mma<BN, VEC>
      <<<grid, Tile<BN>::kThreads, Tile<BN>::kSmem, stream>>>(g);
  return (int)cudaGetLastError();
}

template <bool VEC>
int launch_width(const Geometry& g, int device, cudaStream_t stream) {
  if (g.o <= 16) return launch<16, VEC>(g, device, stream);
  if (g.o <= 64) return launch<64, VEC>(g, device, stream);
  return launch<128, VEC>(g, device, stream);
}

int round_up(long long v, int to) { return (int)((v + to - 1) / to * to); }

}  // namespace mma

}  // namespace

extern "C" {

// x: (n, t, h, w, c) contiguous float32 with c a multiple of 4;
// w: ops/conv_tf32x3.py::pack_weight's (tiles, chunks, 2, bn, 32); bias: (o)
// or null; y: (n, ot, oh, ow, o), which the caller allocates. Strides and
// low-side pads per axis; the high-side pads are implied by the output
// extent. A 2-D convolution passes t = ot = kt = st = 1 and pt = 0. ig and
// og: the input and output channels per convolution group (c and o for
// groups = 1, c padded); cin: the input channels a tile reads per tap (c for
// groups = 1; the channels of the groups a tile covers for groups > 1). bm,
// bn, tiles and cin: ops/conv_tf32x3.py::conv_plan's tile. Returns a CUDA
// error code.
int vft_conv_tf32x3(const void* x, const void* w, const void* bias, void* y,
                    int n, int t, int h, int width, int c, int ot, int oh,
                    int ow, int o, int kt, int kh, int kw, int st, int sh,
                    int sw, int pt, int ph, int pw, int cin, int ig, int og,
                    int bm, int bn, int tiles, int chunks, void* stream) {
  if (n < 0 || t < 1 || h < 1 || width < 1 || c < 4 || c % 4 != 0 || ot < 0
      || oh < 0 || ow < 0 || o < 1 || kt < 1 || kh < 1 || kw < 1 || st < 1
      || sh < 1 || sw < 1 || pt < 0 || ph < 0 || pw < 0
      || (bm != 64 && bm != 128) || bn < 8 || bn % 8 != 0 || tiles < 1
      || cin < 4 || cin % 4 != 0 || ig < 1 || og < 1 || c % ig != 0
      || o % og != 0 || c / ig != o / og)
    return (int)cudaErrorInvalidValue;
  // a tile covers whole groups, or lies inside one, and reads the input
  // channels of exactly those groups; one group: every channel
  const int groups = c / ig;
  const bool tiled = groups == 1
      ? (ig == c && og == o && cin == c)
      : ((bn % og == 0 && cin == bn / og * ig) || (og % bn == 0 && cin == ig));
  const long long quads = (long long)kt * kh * kw * (cin / 4);
  if (!tiled || (long long)n * t * h * width * c >= (1LL << 31)
      || quads * 4 >= (1LL << 31) || chunks != (quads + 7) / 8
      || (long long)tiles * bn < o || (long long)(tiles - 1) * bn >= o
      || ((long long)(tiles - 1) * bn / og) * ig + cin > c)
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0
      || reinterpret_cast<uintptr_t>(x) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long m = (long long)n * ot * oh * ow;
  if (m == 0) return (int)cudaSuccess;
  Conv g{static_cast<const float*>(x), static_cast<const float*>(w),
         static_cast<const float*>(bias), static_cast<float*>(y), m,
         t, h, width, c, ot, oh, ow, o, kt, kh, kw, st, sh, sw, pt, ph, pw,
         cin, ig, og, (int)quads, chunks, 0};
  int device = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return (int)err;
  return launch_tile(g, bm, bn, tiles, device, optin, per_sm,
                     static_cast<cudaStream_t>(stream));
}

// The yardstick: x (n, t, h, w, c) contiguous float32; w:
// ops/conv_tf32x3.py::pack_weight_mma's (k_pad, o_pad) matrix; bias: (o) or
// null; y: (n, ot, oh, ow, o). c_pad is the packed K per tap in vector mode
// (c % 4 == 0: c rounded up to 32) and c in gather mode. Returns a CUDA
// error code.
int vft_conv_tf32x3_mma(const void* x, const void* w, const void* bias,
                        void* y, int n, int t, int h, int width, int c,
                        int ot, int oh, int ow, int o, int kt, int kh, int kw,
                        int st, int sh, int sw, int pt, int ph, int pw,
                        int c_pad, int k_pad, int o_pad, void* stream) {
  if (n < 0 || t < 1 || h < 1 || width < 1 || c < 1 || ot < 0 || oh < 0
      || ow < 0 || o < 1 || kt < 1 || kh < 1 || kw < 1 || st < 1 || sh < 1
      || sw < 1 || pt < 0 || ph < 0 || pw < 0)
    return (int)cudaErrorInvalidValue;
  const long long taps = (long long)kt * kh * kw;
  const bool vec = c % 4 == 0;
  const long long k_real = taps * c;
  const long long k_want = vec ? taps * mma::round_up(c, mma::kBK)
                               : mma::round_up(k_real, mma::kBK);
  if (c_pad != (vec ? mma::round_up(c, mma::kBK) : c) || k_pad != k_want
      || o_pad != mma::round_up(o, mma::kOPadMultiple)
      || k_real >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(w) % 16 != 0
      || (vec && reinterpret_cast<uintptr_t>(x) % 16 != 0))
    return (int)cudaErrorMisalignedAddress;
  const long long m = (long long)n * ot * oh * ow;
  if (m == 0) return (int)cudaSuccess;
  mma::Geometry g{static_cast<const float*>(x), static_cast<const float*>(w),
                  static_cast<const float*>(bias), static_cast<float*>(y), m,
                  t, h, width, c, ot, oh, ow, o, kt, kh, kw, st, sh, sw, pt,
                  ph, pw, (int)k_real, c_pad, k_pad, o_pad};
  int device = 0;
  const cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return vec ? mma::launch_width<true>(g, device, s)
             : mma::launch_width<false>(g, device, s);
}

}  // extern "C"
