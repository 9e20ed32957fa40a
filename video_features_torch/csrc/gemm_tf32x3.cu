// A batched GEMM in 3xTF32 for Hopper (sm_90a), on wgmma: C[b] = alpha *
// A[b] * op(B[b]) (+ bias), fp32 in and out.
//
// Replaces no Pallas kernel. On the TPU the JAX package leaves every linear
// (video_features_tpu/ops/nn.py:145-147) and every attention product
// (ops/attention.py:39,41; models/clip.py:82-105,132,162) to XLA, and under
// precision=mixed and high runs them with the ambient matmul precision
// 'high': three bf16 products per fp32 product
// (video_features_tpu/extract/base.py:166-177). cuBLAS has no three-pass
// mode, so on the card those lanes send every linear, attention product and
// raw matmul of the clip and timm families here (ops/gemm_tf32x3.py,
// ops/nn.py::linear and ::matmul), with cuBLAS's TF32 off for what stays in
// torch. The arithmetic is csrc/conv_tf32x3.cu's: each operand x splits into
// hi = tf32(x) and lo = tf32(x - hi), both rounded to nearest
// (cvt.rna.tf32.f32), and every 32-K chunk sums lo*hi + hi*lo + hi*hi into a
// fresh accumulator that is then added to the running fp32 sum; alpha, then
// the bias. No split-K and no atomics: every output is written once by one
// thread, so results are deterministic.
//
// What it computes: A is (B1, B2, M, K) with K contiguous, element (b1, b2,
// m, k) at a + b1 * sa1 + b2 * sa2 + m * lda + k (B2 = 1 or B1 = 1 for
// three- and two-dimensional operands). B is either
//   * a weight shared by every batch entry, pre-split once for its life by
//     ops/gemm_tf32x3.py (ops/weight_packs.py): conv_tf32x3.py::pack_weight's
//     (tiles, chunks, hi | lo, BN, 32) at the call's BN, each row's 32 K
//     values in the fragment order of ops/gru.py::K_ORDER under the
//     128-byte swizzle the descriptors read ("packed": every linear's (O, I)
//     weight, CLIP's (K, N) projections transposed by the pack), or
//   * an activation (B1, B2, N, K) (kn = 0: QK^T's K) or (B1, B2, K, N)
//     (kn = 1: PV's V), its last axis contiguous, with its own strides,
//     split in the kernel ("raw").
// C is (B1 * B2, M, N), contiguous; bias is (N) or null.
//
// What bounds it on the H100: operations for the linears, bytes for the
// attention products. ViT-B/16 at batch 32 (M = 6304 tokens): 768 -> 2304,
// 768 -> 768, 768 -> 3072 and 3072 -> 768 per layer are 2 * 6304 * 768 *
// 9216 = 89.2 GFLOP, three passes of them 0.54 ms at 495 TFLOP/s (2.67 ms of
// fp32 FMAs at 67 TFLOP/s); QK^T over 384 problems of 197 x 197 x 64 moves
// 2 * 19.4 MB in and 59.6 MB out, 0.024 ms at 3.35 TB/s, against 0.018 ms
// of three-pass products.
//
// Design: a block computes BM = 64 * WGS rows x BN columns of one batch
// entry with WGS warpgroups, fed by a ring of stages with no block-wide
// barrier in the main loop.
//   * A ring of 2..kMaxStages stages (no more than the chunks: the
//     attention products' K of 64 is two) holds each 32-K chunk's A rows
//     and B tile. Its "full" mbarrier completes when
//     they have landed, its "empty" one when every warp is done with them.
//     Chunk c is staged stages - 2 chunks ahead of the products, into the
//     stage chunk c - stages freed two chunks back: one thread issues its
//     TMA and bulk copies (two instructions), no warp waits for a warp
//     still in the chunk before, and the warpgroups drift apart, one
//     flushing while the other's products run.
//     No producer warp: a ninth warp (a lone producer warp, or a producer
//     warpgroup whose registers setmaxnreg lowers) caps every thread at 168
//     registers, three warps sharing an SM quarter's 16,384, and this
//     toolchain's ptxas allocated the consumers within that cap even after
//     setmaxnreg.inc (it did honour setmaxnreg.dec: a producer at 40
//     spilled). BN = 128's sums then spilled, 244 bytes, and the kernel ran
//     ~2x slower than without the flush (tools/gemm_tf32x3_variants.py,
//     PERF.md). Eight warps leave a thread 255 registers.
//   * A: by one TMA tensor-map copy per stage (BM rows x 128 bytes, 128-byte
//     swizzle, zero-filled past M and K) wherever its strides allow it
//     (16-byte aligned base and strides: every linear's rows, the (B, H, S,
//     D) head views as a rank-4 map); otherwise (P's rows of 197, 50 or 257
//     floats) as each row's 16-byte-aligned superset, 9 copies of 16 bytes
//     by cp.async shared by every thread, rows 36 floats apart, read at the
//     row's own offset, the ragged end zero-filled by the copy's src-size
//     so that nothing past a row's K is read.
//   * Packed B: one bulk copy (cp.async.bulk) of the chunk's hi | lo tile.
//     No consumer splits a weight.
//   * Raw B: copied as A's superset rows are; the consumer warpgroups split
//     it together into a ring of two split buffers (hi | lo, K-major,
//     swizzled), each warpgroup half of the tile, between "split full" and
//     "split empty" mbarriers. Chunk q + 1's split runs while chunk q's
//     products do.
//   * Products: each consumer warpgroup of 64 rows queues 12
//     wgmma.mma_async.m64n{BN}k8.f32.tf32.tf32 per chunk with A from
//     registers (each thread loads 8 contiguous floats of its two rows and
//     splits hi and lo there) into a fresh accumulator (part), waits for
//     them, and adds them to the running sum (acc). The next chunk's A rows
//     load while the tensor cores run. acc and part hold BN fp32 registers
//     a thread; the flush is the lane's arithmetic, so the tile stays at BN
//     <= 128.
//   * Tiles (ops/gemm_tf32x3.py::gemm_plan): BN of 16, 32, 64 or 128, the
//     fewest padded columns with a per-tile cost; BM = 128, or 64 where 128
//     would leave SMs idle or M fits in 64 rows (CLIP's 50 tokens, Swin's
//     49-token windows).
//   * Epilogue: alpha times the sum, then the bias, each output written
//     once.
//
// The design before this one stays beside it as the yardstick
// (csrc/gemm_tf32x3_lockstep.cu: every thread copies, the consumers split B
// each chunk, one block barrier a chunk).
//
// Every mbarrier wait is bounded: a barrier that never completes traps (a
// launch error) instead of hanging the card. The entry point launches on the
// given stream, does not synchronize, and returns a CUDA error code (0 on
// success) so the caller can raise on a refused launch.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBK = 32;                  // K per chunk
constexpr int kRowF = kBK + 4;           // floats per staged superset row
constexpr int kMaxStages = 4;
constexpr uint32_t kSpinLimit = 1u << 26;
constexpr int kMaxDevices = 64;

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

// 16 bytes from src to dst, of which the first `bytes` are read and the
// rest zero-filled
__device__ __forceinline__ void copy16(uint32_t dst, const void* src,
                                       int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

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

// one arrival that also expects `bytes` of asynchronous copies
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// bytes from src to dst by one bulk copy, completing on bar
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          int bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

// a box of the rank-4 tensor map at (c0, c1, c2, c3), completing on bar
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
      :: "r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
         "r"(c2), "r"(c3), "r"(bar) : "memory");
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

struct Gemm {
  const float* a;        // (B1, B2, M, K), K contiguous
  const float* b;        // packed tiles, or raw (B1, B2, N, K) / (B1, B2, K, N)
  const float* bias;     // (N) or null
  float* c;              // (B1 * B2, M, N), contiguous
  long long sa1, sa2;    // A's batch strides (floats)
  long long sb1, sb2;    // raw B's
  int lda, ldb;          // row strides (floats)
  int m, n, k;
  int b2;                // extent of the inner batch axis
  int m_tiles;           // row tiles per batch entry
  int kn;                // raw B is (K, N)
  int a_tma;             // A's stages come by the tensor map
  float alpha;
  int chunks;            // 32-K chunks
  int stages;            // ring depth, 2..kMaxStages
};

constexpr int round_1k(int v) { return (v + 1023) / 1024 * 1024; }

template <int WGS, int BN, bool PACKED>
struct Ws {
  static constexpr int kBM = 64 * WGS;
  // no warp beside the consumers: with 8 warps (two of an SM quarter's
  // 16,384 registers each) a thread may take 255 registers; one consumer
  // warpgroup: two blocks share an SM
  static constexpr int kThreads = 128 * WGS;
  static constexpr int kBlocksPerSm = WGS == 1 ? 2 : 1;
  static constexpr int kTile = 2 * BN * kBK * 4;        // one hi | lo tile
  // a raw tile: BN superset rows of 36 floats (N, K), or 32 of BN + 4 (K, N)
  static constexpr int kRawB = BN * kRowF > kBK * (BN + 4) ? BN * kRowF * 4
                                                           : kBK * (BN + 4) * 4;
  static constexpr int kBBytes = PACKED ? kTile : round_1k(kRawB);
  // a TMA tile (BM x 128 bytes, swizzled) or BM superset rows of 36 floats
  static constexpr int kABytes = round_1k(kBM * kRowF * 4);
  static constexpr int kStageBytes = kBBytes + kABytes;
  static constexpr int kSplitBytes = PACKED ? 0 : 2 * kTile;   // the split ring
  // alignment slack, the split ring, the mbarriers
  static constexpr int kFixedBytes = 1024 + kSplitBytes + (2 * kMaxStages + 4) * 8;
  static constexpr size_t smem(int stages) {
    return (size_t)kFixedBytes + (size_t)stages * kStageBytes;
  }
};

// natural K position kk (0..31) of a chunk -> its packed position in a
// split row: ops/gru.py::K_ORDER's inverse (position 8k + c holds
// 8 * (c % 4) + 2k + c / 4), then the 128-byte swizzle of row n
__device__ __forceinline__ int split_pos(int n, int kk) {
  const int p = 8 * ((kk & 7) >> 1) + (kk & 1) * 4 + (kk >> 3);
  return n * kBK + (((p >> 2) ^ (n & 7)) << 2) + (p & 3);
}

// The block's threads stage `rows` rows of a row-major matrix (row stride
// ld floats), from row row0 and column c0, each as its 16-byte-aligned
// superset: COPIES copies of 16 bytes into staged rows WIDTH floats apart,
// thread `tid` of THREADS taking copies tid, tid + THREADS, ...
// A copy reads only the columns below `cols` of rows below `row_end`
// (src-size), zero-filling the rest, so nothing past a row's end is read;
// a staged row's first column c0 lies at its offset (start / 4) % 4.
template <int COPIES, int WIDTH, int THREADS>
__device__ __forceinline__ void stage_rows(uint32_t dst, const float* base,
                                           int ld, int row0, int rows,
                                           int row_end, int c0, int cols,
                                           int tid) {
  for (int i = tid; i < rows * COPIES; i += THREADS) {
    const int r = i / COPIES, j = i - r * COPIES;
    const int row = row0 + r;
    const uintptr_t start =
        reinterpret_cast<uintptr_t>(base + (size_t)row * ld + c0);
    const int c = c0 - (int)((start >> 2) & 3) + 4 * j;   // its first column
    int valid = row < row_end ? cols - c : 0;
    valid = valid < 0 ? 0 : (valid > 4 ? 4 : valid);
    const void* src = valid
        ? reinterpret_cast<const void*>((start & ~(uintptr_t)15) + 16 * j)
        : static_cast<const void*>(base);
    copy16(dst + (r * WIDTH + 4 * j) * 4, src, 4 * valid);
  }
}

// WGS: consumer warpgroups (BM = 64 * WGS rows per block); BN: columns per
// block; PACKED: B is a pre-split weight (else raw, split here).
template <int WGS, int BN, bool PACKED>
__global__ void __launch_bounds__(Ws<WGS, BN, PACKED>::kThreads,
                                  Ws<WGS, BN, PACKED>::kBlocksPerSm)
gemm_tf32x3_ws(const __grid_constant__ CUtensorMap amap, const Gemm g) {
  using T = Ws<WGS, BN, PACKED>;
  constexpr int BM = T::kBM;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled tiles want 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint8_t* splits = base;                        // 2 x (hi | lo), raw B only
  uint8_t* ring = base + T::kSplitBytes;         // stages x (B | A)
  // full[s]: stage s landed; empty[s]: every consumer warp is done with it;
  // sfull[j], sempty[j]: split buffer j written, and read by the products
  uint64_t* full = reinterpret_cast<uint64_t*>(
      ring + (size_t)g.stages * T::kStageBytes);
  uint64_t* empty = full + kMaxStages;
  uint64_t* sfull = empty + kMaxStages;
  uint64_t* sempty = sfull + 2;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int z = blockIdx.x / g.m_tiles;              // batch entry
  const int m0 = (blockIdx.x - z * g.m_tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int z1 = z / g.b2, z2 = z - z1 * g.b2;
  const float* abase = g.a + z1 * g.sa1 + z2 * g.sa2;
  const float* bbase = PACKED
      ? g.b + (size_t)blockIdx.y * g.chunks * (T::kTile / 4)
      : g.b + z1 * g.sb1 + z2 * g.sb2;
  const uint32_t ring_addr = smem_addr(ring);

  // the stages come by TMA and bulk copies alone (one thread issues them)
  // or some of their rows by every thread's cp.async (supersets)
  const bool spread = !g.a_tma || !PACKED;
  if (tid == 0) {
    for (int i = 0; i < g.stages; ++i) {
      // thread 0's expect_tx, and every thread's copies where spread
      mbar_init(smem_addr(&full[i]), 1 + (spread ? T::kThreads : 0));
      mbar_init(smem_addr(&empty[i]), 4 * WGS);        // warps
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(smem_addr(&sfull[i]), 4 * WGS);
      mbar_init(smem_addr(&sempty[i]), 4 * WGS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Chunk c into stage c % stages, once every warp has released that
  // stage's last chunk, c - stages: thread 0 issues the TMA and bulk
  // copies; where spread, every thread copies its share of the superset
  // rows and arrives on full[s] once its copies have landed.
  auto stage = [&](int c) {
    const int s = c % g.stages;
    if (!spread && tid != 0) return;
    if (c >= g.stages) mbar_wait(smem_addr(&empty[s]), (c / g.stages - 1) & 1);
    const uint32_t bar = smem_addr(&full[s]);
    const uint32_t sb = ring_addr + s * T::kStageBytes;
    const uint32_t sa = sb + T::kBBytes;
    const int k0 = c * kBK;
    if (tid == 0) {
      mbar_expect(bar, (g.a_tma ? BM * kBK * 4 : 0) + (PACKED ? T::kTile : 0));
      if (PACKED)
        bulk_load(sb, bbase + (size_t)c * (T::kTile / 4), T::kTile, bar);
      if (g.a_tma) tma_load(sa, &amap, k0, m0, z2, z1, bar);
    }
    if (!spread) return;
    if (!g.a_tma)
      stage_rows<9, kRowF, T::kThreads>(sa, abase, g.lda, m0, BM, g.m, k0,
                                        g.k, tid);
    if (!PACKED) {
      if (!g.kn)
        stage_rows<9, kRowF, T::kThreads>(sb, bbase, g.ldb, n0, BN, g.n, k0,
                                          g.k, tid);
      else
        stage_rows<BN / 4 + 1, BN + 4, T::kThreads>(sb, bbase, g.ldb, k0, kBK,
                                                    g.k, n0, g.n, tid);
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(bar) : "memory");
  };
  // chunks are staged `ahead` chunks ahead, each into the stage that chunk
  // c - stages freed: with ahead = stages - 2 that is two chunks back, so
  // no warp waits for a warp still in the chunk before and the warpgroups
  // drift apart (one flushes while the other queues its products)
  const int ahead = g.stages > 2 ? g.stages - 2 : 1;
  for (int c = 0; c < ahead && c < g.chunks; ++c) stage(c);

  {
    // this thread's rows: fragment rows g and g + 8 of its warp
    const int r0 = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + lane / 4;
    const int t = lane % 4;
    // a superset row's offset (constant over the chunks: K advances by 128
    // bytes a chunk)
    int oa0 = 0, oa1 = 0;
    if (!g.a_tma) {
      oa0 = (int)((reinterpret_cast<uintptr_t>(abase + (size_t)(m0 + r0) * g.lda)
                   >> 2) & 3);
      oa1 = (int)((reinterpret_cast<uintptr_t>(abase + (size_t)(m0 + r0 + 8) * g.lda)
                   >> 2) & 3);
    }
    // a chunk's 8 contiguous floats of each row (the split rows' K order
    // puts k8 step k's fragment columns t and t + 4 at K 8t + 2k and
    // 8t + 2k + 1)
    float4 x[4];
    auto load_rows = [&](int s) {
      const uint8_t* st = ring + (size_t)s * T::kStageBytes + T::kBBytes;
      if (g.a_tma) {
        // row r's 16-byte chunk c at c ^ (r % 8); r0 % 8 == lane / 4
        const uint8_t* r = st + r0 * 128;
        const int c0 = ((2 * t) ^ (lane / 4)) << 4, c1 = ((2 * t + 1) ^ (lane / 4)) << 4;
        x[0] = *reinterpret_cast<const float4*>(r + c0);
        x[1] = *reinterpret_cast<const float4*>(r + c1);
        x[2] = *reinterpret_cast<const float4*>(r + 1024 + c0);
        x[3] = *reinterpret_cast<const float4*>(r + 1024 + c1);
      } else {
        const float* r = reinterpret_cast<const float*>(st) + r0 * kRowF + 8 * t;
        const float* p0 = r + oa0;
        const float* p1 = r + 8 * kRowF + oa1;
        x[0] = make_float4(p0[0], p0[1], p0[2], p0[3]);
        x[1] = make_float4(p0[4], p0[5], p0[6], p0[7]);
        x[2] = make_float4(p1[0], p1[1], p1[2], p1[3]);
        x[3] = make_float4(p1[4], p1[5], p1[6], p1[7]);
      }
    };
    float acc[BN / 2], part[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
    uint32_t hi[4][4], lo[4][4];
    auto split_rows = [&]() {
      // fragment order: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const float v[4][4] = {{x[0].x, x[2].x, x[0].y, x[2].y},
                             {x[0].z, x[2].z, x[0].w, x[2].w},
                             {x[1].x, x[3].x, x[1].y, x[3].y},
                             {x[1].z, x[3].z, x[1].w, x[3].w}};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[k][e], hi[k][e], lo[k][e]);
    };
    auto products = [&](uint32_t bhi) {
      const uint32_t blo = bhi + BN * kBK * 4;
      fence_regs(part);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_tf32<BN>(part, lo[k], b_desc(bhi + 32 * k), k > 0);   // a fresh sum
        wgmma_tf32<BN>(part, hi[k], b_desc(blo + 32 * k), 1);
        wgmma_tf32<BN>(part, hi[k], b_desc(bhi + 32 * k), 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      fence_regs(part);
    };
    // once the products are done: their sum into the running one
    auto flush = [&]() {
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_regs(part);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        fence_regs(hi[k]);
        fence_regs(lo[k]);
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
    };
    auto release = [&](uint64_t* bar) {
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_addr(bar));
    };

    if constexpr (PACKED) {
      int s = 0;
      mbar_wait(smem_addr(&full[0]), 0);
      load_rows(0);
#pragma unroll 1
      for (int q = 0; q < g.chunks; ++q) {
        split_rows();
        products(ring_addr + s * T::kStageBytes);
        // while the tensor cores run: chunk q + ahead's copies and the next
        // chunk's rows
        if (q + ahead < g.chunks) stage(q + ahead);
        const int sn = s + 1 == g.stages ? 0 : s + 1;
        if (q + 1 < g.chunks) {
          mbar_wait(smem_addr(&full[sn]), ((q + 1) / g.stages) & 1);
          load_rows(sn);
        }
        flush();
        release(&empty[s]);
        s = sn;
      }
    } else {
      // the warpgroups split raw B together: thread t of kThreads takes
      // elements t, t + kThreads, ... of the BN x 32 tile
      auto split_b = [&](int s, int j, int k0) {
        const float* rb = reinterpret_cast<const float*>(
            ring + (size_t)s * T::kStageBytes);
        uint32_t* phi = reinterpret_cast<uint32_t*>(splits + j * T::kTile);
        uint32_t* plo = phi + BN * kBK;
        if (!g.kn) {
          for (int i = tid; i < BN * kBK; i += T::kThreads) {
            const int n = i >> 5, kk = i & 31;
            const int o = (int)((reinterpret_cast<uintptr_t>(
                                    bbase + (size_t)(n0 + n) * g.ldb) >> 2) & 3);
            uint32_t h, l;
            split(rb[n * kRowF + o + kk], h, l);
            const int pos = split_pos(n, kk);
            phi[pos] = h;
            plo[pos] = l;
          }
        } else {
          for (int i = tid; i < BN * kBK; i += T::kThreads) {
            const int kk = i / BN, n = i % BN;
            const int o = (int)((reinterpret_cast<uintptr_t>(
                                    bbase + (size_t)(k0 + kk) * g.ldb + n0) >> 2) & 3);
            uint32_t h, l;
            split(rb[kk * (BN + 4) + o + n], h, l);
            const int pos = split_pos(n, kk);
            phi[pos] = h;
            plo[pos] = l;
          }
        }
        // the split tile is read by the async proxy (wgmma)
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        release(&sfull[j]);
      };
      int s = 0;
      mbar_wait(smem_addr(&full[0]), 0);
      split_b(0, 0, 0);
      load_rows(0);
      release(&empty[0]);
#pragma unroll 1
      for (int q = 0; q < g.chunks; ++q) {
        const int j = q & 1;
        split_rows();
        mbar_wait(smem_addr(&sfull[j]), (q >> 1) & 1);
        products(smem_addr(splits) + j * T::kTile);
        // while the tensor cores run: chunk q + ahead's copies, and the next
        // chunk's split (into the buffer chunk q - 1's products freed) and
        // rows
        if (q + ahead < g.chunks) stage(q + ahead);
        if (q + 1 < g.chunks) {
          const int sn = s + 1 == g.stages ? 0 : s + 1;
          const int jn = (q + 1) & 1;
          mbar_wait(smem_addr(&full[sn]), ((q + 1) / g.stages) & 1);
          if (q >= 1) mbar_wait(smem_addr(&sempty[jn]), (((q + 1) >> 1) - 1) & 1);
          split_b(sn, jn, (q + 1) * kBK);
          load_rows(sn);
          release(&empty[sn]);
          s = sn;
        }
        flush();
        release(&sempty[j]);
      }
    }

    // Epilogue: acc[4j + 2i + e] is row m0 + r0 + 8i, column 8j + 2t + e
    // of this block's BN.
    float* cz = g.c + (size_t)z * g.m * g.n;
    const bool pairs = g.n % 2 == 0;       // an aligned float2
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int m = m0 + r0 + 8 * i;
      if (m >= g.m) continue;
      float* crow = cz + (size_t)m * g.n;
#pragma unroll
      for (int jn = 0; jn < BN / 8; ++jn) {
        const int n = n0 + 8 * jn + 2 * t;
        if (n >= g.n) continue;
        float v0 = __fmul_rn(g.alpha, acc[4 * jn + 2 * i]);
        if (g.bias != nullptr) v0 = __fadd_rn(v0, __ldg(g.bias + n));
        if (n + 1 < g.n) {
          float v1 = __fmul_rn(g.alpha, acc[4 * jn + 2 * i + 1]);
          if (g.bias != nullptr) v1 = __fadd_rn(v1, __ldg(g.bias + n + 1));
          if (pairs) {
            *reinterpret_cast<float2*>(crow + n) = make_float2(v0, v1);
          } else {
            crow[n] = v0;
            crow[n + 1] = v1;
          }
        } else {
          crow[n] = v0;
        }
      }
    }
  }
}

// Raise a kernel's dynamic shared memory limit once per device ordinal (a
// function's attributes are kept per device context).
cudaError_t raise_smem(const void* kernel, std::atomic<int>* set, int device,
                       int bytes) {
  if (set[device].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set[device].store(bytes, std::memory_order_release);
  return err;
}

// The ring's depth for an instantiation on this device: as many stages as
// the block's share of shared memory holds, 2..kMaxStages (0: not even 2).
// One consumer warpgroup asks for half an SM first, so that two blocks
// share it.
template <class T>
int ring_stages(int optin, int per_sm) {
  long long budget = optin;
  if (T::kBlocksPerSm == 2) {
    const long long half = per_sm / 2 - 1024;
    if (half < budget && (half - T::kFixedBytes) / T::kStageBytes >= 2)
      budget = half;
  }
  const long long fit = (budget - T::kFixedBytes) / T::kStageBytes;
  if (fit < 2) return 0;
  return fit < kMaxStages ? (int)fit : kMaxStages;
}

template <int WGS, int BN, bool PACKED>
int launch(Gemm g, const CUtensorMap& amap, long long batch, int n_tiles,
           int device, int optin, int per_sm, cudaStream_t stream) {
  using T = Ws<WGS, BN, PACKED>;
  static std::atomic<int> set[kMaxDevices];
  g.stages = ring_stages<T>(optin, per_sm);
  if (!g.stages) return (int)cudaErrorInvalidValue;
  // no deeper than the chunks (the attention products' K of 64 is two)
  if (g.stages > g.chunks) g.stages = g.chunks < 2 ? 2 : g.chunks;
  const size_t smem = T::smem(g.stages);
  cudaError_t err = raise_smem(
      reinterpret_cast<const void*>(gemm_tf32x3_ws<WGS, BN, PACKED>), set,
      device, (int)smem);
  if (err != cudaSuccess) return (int)err;
  g.m_tiles = (g.m + T::kBM - 1) / T::kBM;
  const long long blocks = batch * g.m_tiles;
  if (blocks >= (1LL << 31) || n_tiles > 65535) return (int)cudaErrorInvalidValue;
  gemm_tf32x3_ws<WGS, BN, PACKED>
      <<<dim3((unsigned)blocks, (unsigned)n_tiles), T::kThreads, smem, stream>>>(
          amap, g);
  return (int)cudaGetLastError();
}

// Each device's shared memory limits, read once.
struct DeviceLimits {
  std::atomic<int> optin{0}, per_sm{0};
};
DeviceLimits limits[kMaxDevices];

cudaError_t device_limits(int device, int* optin, int* per_sm) {
  *optin = limits[device].optin.load(std::memory_order_acquire);
  *per_sm = limits[device].per_sm.load(std::memory_order_acquire);
  if (*optin && *per_sm) return cudaSuccess;
  cudaError_t err = cudaDeviceGetAttribute(
      optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return err;
  limits[device].optin.store(*optin, std::memory_order_release);
  limits[device].per_sm.store(*per_sm, std::memory_order_release);
  return cudaSuccess;
}

// The driver's cuTensorMapEncodeTiled, found once through the runtime (no
// link against the driver library).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static std::atomic<EncodeTiled> found{nullptr};
  static std::atomic<int> missing{0};
  EncodeTiled fn = found.load(std::memory_order_acquire);
  if (fn != nullptr || missing.load(std::memory_order_acquire)) return fn;
  void* p = nullptr;
  cudaDriverEntryPointQueryResult status;
#if CUDART_VERSION >= 12050
  cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &status);
#else
  cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                            cudaEnableDefault, &status);
#endif
  if (err != cudaSuccess || status != cudaDriverEntryPointSuccess || !p) {
    missing.store(1, std::memory_order_release);
    return nullptr;
  }
  fn = reinterpret_cast<EncodeTiled>(p);
  found.store(fn, std::memory_order_release);
  return fn;
}

// A's rank-4 tensor map (K, M, B2, B1), boxes of 32 x bm, 128-byte swizzle,
// zero-filled outside: true where A's base and strides are 16-byte aligned
// and the driver encodes it. An axis of extent 1 takes a stride past the
// rows, never read.
bool encode_a(CUtensorMap* map, const void* a, int b1, int b2, int m, int k,
              long long sa1, long long sa2, int lda, int bm) {
  if (reinterpret_cast<uintptr_t>(a) % 16 != 0 || lda % 4 != 0
      || (b2 > 1 && sa2 % 4 != 0) || (b1 > 1 && sa1 % 4 != 0))
    return false;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return false;
  const cuuint64_t past = (cuuint64_t)lda * 4 * (cuuint64_t)m;
  const cuuint64_t dims[4] = {(cuuint64_t)k, (cuuint64_t)m, (cuuint64_t)b2,
                              (cuuint64_t)b1};
  const cuuint64_t strides[3] = {(cuuint64_t)lda * 4,
                                 b2 > 1 ? (cuuint64_t)sa2 * 4 : past,
                                 b1 > 1 ? (cuuint64_t)sa1 * 4 : past};
  for (cuuint64_t s : strides)
    if (s == 0 || s >= (1ULL << 40)) return false;
  const cuuint32_t box[4] = {(cuuint32_t)kBK, (cuuint32_t)bm, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(a),
                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// a: (b1, b2, m, k) at a + i1 * sa1 + i2 * sa2 + row * lda + col. packed =
// 1: b is ops/conv_tf32x3.py::pack_weight's (ceil(n / bn), ceil(k / 32), 2,
// bn, 32) for the GEMM's B (its columns the output's n), 16-byte aligned;
// packed = 0: b is (b1, b2, n, k) (kn = 0) or (b1, b2, k, n) (kn = 1) with
// strides sb1, sb2 and ldb. bias: (n) or null; c: (b1 * b2, m, n)
// contiguous, which the caller allocates. bm (64 or 128) and bn (16, 32, 64
// or 128): ops/gemm_tf32x3.py::gemm_plan's tile. device: the current
// device's ordinal. Strides and extents in floats. Returns a CUDA error
// code.
int vft_gemm_tf32x3(const void* a, const void* b, const void* bias, void* c,
                    int b1, int b2, int m, int n, int k, long long sa1,
                    long long sa2, int lda, long long sb1, long long sb2,
                    int ldb, int kn, int packed, float alpha, int bm, int bn,
                    int device, void* stream) {
  if (b1 < 0 || b2 < 1 || m < 0 || n < 0 || k < 1 || lda < 1 || ldb < 1
      || sa1 < 0 || sa2 < 0 || sb1 < 0 || sb2 < 0 || (kn != 0 && kn != 1)
      || (packed != 0 && packed != 1) || (bm != 64 && bm != 128))
    return (int)cudaErrorInvalidValue;
  if (lda < k || (!packed && (!kn ? ldb < k : ldb < n)))
    return (int)cudaErrorInvalidValue;
  if (device < 0 || device >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (reinterpret_cast<uintptr_t>(c) % 8 != 0
      || reinterpret_cast<uintptr_t>(a) % 4 != 0
      || reinterpret_cast<uintptr_t>(b) % (packed ? 16 : 4) != 0)
    return (int)cudaErrorMisalignedAddress;
  const long long batch = (long long)b1 * b2;
  if (batch == 0 || m == 0 || n == 0) return (int)cudaSuccess;
  const int n_tiles = (n + bn - 1) / bn;
  Gemm g{static_cast<const float*>(a), static_cast<const float*>(b),
         static_cast<const float*>(bias), static_cast<float*>(c), sa1, sa2,
         sb1, sb2, lda, ldb, m, n, k, b2, 0, kn, 0, alpha,
         (k + kBK - 1) / kBK, 0};
  CUtensorMap amap{};
  g.a_tma = encode_a(&amap, a, b1, b2, m, k, sa1, sa2, lda, bm);
  int optin = 0, per_sm = 0;
  const cudaError_t err = device_limits(device, &optin, &per_sm);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tile widths: ops/gemm_tf32x3.py::GEMM_WIDTHS
#define VFT_GEMM_WIDTH(W)                                                     \
  case W:                                                                     \
    if (packed)                                                               \
      return bm == 128                                                        \
          ? launch<2, W, true>(g, amap, batch, n_tiles, device, optin, per_sm, s) \
          : launch<1, W, true>(g, amap, batch, n_tiles, device, optin, per_sm, s); \
    return bm == 128                                                          \
        ? launch<2, W, false>(g, amap, batch, n_tiles, device, optin, per_sm, s) \
        : launch<1, W, false>(g, amap, batch, n_tiles, device, optin, per_sm, s);
  switch (bn) {
    VFT_GEMM_WIDTH(16)
    VFT_GEMM_WIDTH(32)
    VFT_GEMM_WIDTH(64)
    VFT_GEMM_WIDTH(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VFT_GEMM_WIDTH
}

// Whether a launch with these A operands takes A's rows by the tensor map
// (1) or as cp.async supersets (0): the test of vft_gemm_tf32x3.
int vft_gemm_tf32x3_a_by_tma(const void* a, int b1, int b2, int m, int k,
                             long long sa1, long long sa2, int lda, int bm) {
  CUtensorMap map{};
  return encode_a(&map, a, b1, b2, m, k, sa1, sa2, lda, bm) ? 1 : 0;
}

}  // extern "C"
