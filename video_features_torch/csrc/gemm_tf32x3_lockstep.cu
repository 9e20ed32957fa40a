// The 3xTF32 GEMM's earlier design, kept as a yardstick on no path
// (ops/gemm_tf32x3.py::gemm_tf32x3_lockstep; chip_smoke.py and the card's
// tests time it in turns with csrc/gemm_tf32x3.cu's kernel, and
// tools/gemm_tf32x3_variants.py --design lockstep ablates it). The
// arithmetic is the kernel's: each operand x splits into hi = tf32(x) and
// lo = tf32(x - hi), rounded to nearest (cvt.rna.tf32.f32), and every 32-K
// chunk sums lo*hi + hi*lo + hi*hi into a fresh accumulator that is then
// added to the running fp32 sum; alpha, then the bias.
//
// What it computes: A is (B1, B2, M, K) with K contiguous, element (b1, b2,
// m, k) at a + b1 * sa1 + b2 * sa2 + m * lda + k (strides of 0 for a
// weight that every batch shares). B is (B1, B2, N, K) (kn = 0) or (B1,
// B2, K, N) (kn = 1), its last axis contiguous. C is (B1 * B2, M, N),
// contiguous. Ragged M, N and K are masked in the kernel; an operand whose
// rows are not 16-byte aligned is read 4 bytes at a time.
//
// Design ("lockstep"): a block computes BM = 64 * WGS rows x BN columns of
// one batch entry with WGS warpgroups and no producer.
//   * Every thread issues the cp.async copies of a ring of 2..kMaxStages
//     stages (each 32-K chunk's A rows and raw fp32 B tile) and arrives on
//     the stage's "full" mbarrier.
//   * Each chunk the consumers split the whole B tile into TF32 hi and lo,
//     K-major in the 128-byte swizzle wgmma's descriptors read, into one
//     of two buffers, fence the async proxy and meet at a block barrier.
//   * Products: each warpgroup of 64 rows queues 12
//     wgmma.mma_async.m64n{BN}k8.f32.tf32.tf32 per chunk with A from
//     registers into a fresh accumulator, waits for them (wait_group 0)
//     and adds them to the running sum.
// Measured (tools/gemm_tf32x3_variants.py, NVIDIA H100 80GB HBM3, 700 W;
// PERF.md): over ViT-B/16's batch-32 step 22.7% of the 3xTF32 bound; the
// copies and splits alone (no product) 80% of its time, the products with
// no copy and no split 67%.
//
// Every mbarrier wait is bounded: a barrier that never completes traps (a
// launch error) instead of hanging the card. The entry point launches on the
// given stream, does not synchronize, and returns a CUDA error code.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kBK = 32;                  // K per chunk
constexpr int kLda = kBK + 4;            // floats per staged K-major row
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

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}

// Raise a kernel's dynamic shared memory limit once per device ordinal (a
// function's attributes are kept per device context).
cudaError_t raise_smem(const void* kernel, std::atomic<int>* set, int device,
                       int bytes) {
  if (device < 0 || device >= kMaxDevices) return cudaErrorInvalidDevice;
  if (set[device].load(std::memory_order_acquire) >= bytes) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) set[device].store(bytes, std::memory_order_release);
  return err;
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
  const float* b;        // (B1, B2, N, K) or (B1, B2, K, N), last axis contiguous
  const float* bias;     // (N) or null
  float* c;              // (B1 * B2, M, N), contiguous
  long long sa1, sa2;    // A's batch strides (floats)
  long long sb1, sb2;    // B's
  int lda, ldb;          // row strides (floats)
  int m, n, k;
  int b2;                // extent of the inner batch axis
  int m_tiles;           // row tiles per batch entry
  int kn;                // B is (K, N)
  int vec_a, vec_b;      // 16-byte copies (rows 16-byte aligned)
  float alpha;
  int chunks;            // 32-K chunks
  int stages;            // ring depth, 2..kMaxStages
};

template <int WGS, int BN>
struct Gt {
  static constexpr int kBM = 64 * WGS;
  static constexpr int kThreads = 128 * WGS;
  static constexpr int kSplitBytes = 2 * BN * kBK * 4;   // hi | lo
  static constexpr int kAFloats = kBM * kLda;
  // a (BN x 32) tile 36 floats a row, or a (32 x BN) tile BN + 4 a row
  static constexpr int kBFloats =
      BN * kLda > kBK * (BN + 4) ? BN * kLda : kBK * (BN + 4);
  static constexpr int kStageBytes = (kAFloats + kBFloats) * 4;
  // alignment slack, the two split buffers, the mbarriers
  static constexpr int kFixedBytes = 1024 + 2 * kSplitBytes + kMaxStages * 8;
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

template <int WGS, int BN>
__global__ void __launch_bounds__(Gt<WGS, BN>::kThreads, 1)
gemm_tf32x3_lockstep(const Gemm g) {
  using T = Gt<WGS, BN>;
  constexpr int BM = T::kBM;
  extern __shared__ uint8_t smem_raw[];
  // the swizzled split tiles want 1024-byte alignment
  const uint32_t raw = smem_addr(smem_raw);
  uint8_t* base = smem_raw + ((1024 - (raw & 1023)) & 1023);
  uint32_t* split_buf = reinterpret_cast<uint32_t*>(base);   // 2 x (hi | lo)
  float* ring = reinterpret_cast<float*>(base + 2 * T::kSplitBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      base + 2 * T::kSplitBytes + (size_t)g.stages * T::kStageBytes);

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int z = blockIdx.x / g.m_tiles;              // batch entry
  const int m0 = (blockIdx.x - z * g.m_tiles) * BM;
  const int n0 = blockIdx.y * BN;
  const int z1 = z / g.b2, z2 = z - z1 * g.b2;
  const float* abase = g.a + z1 * g.sa1 + z2 * g.sa2;
  const float* bbase = g.b + z1 * g.sb1 + z2 * g.sb2;

  if (tid == 0) {
    for (int i = 0; i < g.stages; ++i) mbar_init(smem_addr(&full[i]), T::kThreads);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Chunk q into stage s: A's BM rows and B's tile, 16 or 4 bytes a copy,
  // zero-filled outside the matrices; every thread arrives on full[s] once
  // its copies have landed.
  auto stage_chunk = [&](int q, int s) {
    float* as = ring + (size_t)s * (T::kAFloats + T::kBFloats);
    float* bs = as + T::kAFloats;
    const int k0 = q * kBK;
    if (g.vec_a) {
      for (int i = tid; i < BM * 8; i += T::kThreads) {
        const int r = i >> 3, j = i & 7;
        const int m = m0 + r, kk = k0 + 4 * j;
        const bool ok = m < g.m && kk < g.k;
        cp_async16(smem_addr(as + r * kLda + 4 * j),
                   ok ? abase + (size_t)m * g.lda + kk : g.a, ok);
      }
    } else {
      for (int i = tid; i < BM * kBK; i += T::kThreads) {
        const int r = i >> 5, j = i & 31;
        const int m = m0 + r, kk = k0 + j;
        const bool ok = m < g.m && kk < g.k;
        cp_async4(smem_addr(as + r * kLda + j),
                  ok ? abase + (size_t)m * g.lda + kk : g.a, ok);
      }
    }
    if (!g.kn) {                       // (N, K): BN rows of 32 K
      if (g.vec_b) {
        for (int i = tid; i < BN * 8; i += T::kThreads) {
          const int r = i >> 3, j = i & 7;
          const int n = n0 + r, kk = k0 + 4 * j;
          const bool ok = n < g.n && kk < g.k;
          cp_async16(smem_addr(bs + r * kLda + 4 * j),
                     ok ? bbase + (size_t)n * g.ldb + kk : g.b, ok);
        }
      } else {
        for (int i = tid; i < BN * kBK; i += T::kThreads) {
          const int r = i >> 5, j = i & 31;
          const int n = n0 + r, kk = k0 + j;
          const bool ok = n < g.n && kk < g.k;
          cp_async4(smem_addr(bs + r * kLda + j),
                    ok ? bbase + (size_t)n * g.ldb + kk : g.b, ok);
        }
      }
    } else {                           // (K, N): 32 rows of BN
      constexpr int ldr = BN + 4;
      if (g.vec_b) {
        for (int i = tid; i < kBK * (BN / 4); i += T::kThreads) {
          const int r = i / (BN / 4), j = i - r * (BN / 4);
          const int kk = k0 + r, n = n0 + 4 * j;
          const bool ok = kk < g.k && n < g.n;
          cp_async16(smem_addr(bs + r * ldr + 4 * j),
                     ok ? bbase + (size_t)kk * g.ldb + n : g.b, ok);
        }
      } else {
        for (int i = tid; i < kBK * BN; i += T::kThreads) {
          const int r = i / BN, j = i - r * BN;
          const int kk = k0 + r, n = n0 + j;
          const bool ok = kk < g.k && n < g.n;
          cp_async4(smem_addr(bs + r * ldr + j),
                    ok ? bbase + (size_t)kk * g.ldb + n : g.b, ok);
        }
      }
    }
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
                 :: "r"(smem_addr(&full[s])) : "memory");
  };
  const int first = g.stages < g.chunks ? g.stages : g.chunks;
  for (int q = 0; q < first; ++q) stage_chunk(q, q);

  // this thread's rows: fragment rows g and g + 8 of its warp
  const int r0 = (tid / 128) * 64 + ((tid / 32) % 4) * 16 + lane / 4;
  float acc[BN / 2], part[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = part[i] = 0.f;
  uint32_t hi[4][4], lo[4][4];

#pragma unroll 1
  for (int q = 0; q < g.chunks; ++q) {
    const int s = q % g.stages;
    mbar_wait(smem_addr(&full[s]), (q / g.stages) & 1);
    const float* as = ring + (size_t)s * (T::kAFloats + T::kBFloats);
    const float* bs = as + T::kAFloats;
    // A: 8 contiguous floats of each of this thread's two rows (the split
    // rows' K order puts k8 step k's fragment columns t and t + 4 at K
    // 8t + 2k and 8t + 2k + 1), split into hi and lo
    {
      const float* r = as + r0 * kLda + 8 * (lane % 4);
      const float4 x0 = *reinterpret_cast<const float4*>(r);
      const float4 x1 = *reinterpret_cast<const float4*>(r + 4);
      const float4 x2 = *reinterpret_cast<const float4*>(r + 8 * kLda);
      const float4 x3 = *reinterpret_cast<const float4*>(r + 8 * kLda + 4);
      // fragment order: (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
      const float v[4][4] = {{x0.x, x2.x, x0.y, x2.y},
                             {x0.z, x2.z, x0.w, x2.w},
                             {x1.x, x3.x, x1.y, x3.y},
                             {x1.z, x3.z, x1.w, x3.w}};
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 4; ++e) split(v[k][e], hi[k][e], lo[k][e]);
    }
    // B: the tile split into hi and lo, K-major and swizzled, into buffer
    // q % 2
    uint32_t* phi = split_buf + (q & 1) * (2 * BN * kBK);
    uint32_t* plo = phi + BN * kBK;
    if (!g.kn) {
      for (int i = tid; i < BN * kBK; i += T::kThreads) {
        const int n = i >> 5, kk = i & 31;
        uint32_t h, l;
        split(bs[n * kLda + kk], h, l);
        const int pos = split_pos(n, kk);
        phi[pos] = h;
        plo[pos] = l;
      }
    } else {
      for (int i = tid; i < BN * kBK; i += T::kThreads) {
        const int kk = i / BN, n = i - kk * BN;
        uint32_t h, l;
        split(bs[kk * (BN + 4) + n], h, l);
        const int pos = split_pos(n, kk);
        phi[pos] = h;
        plo[pos] = l;
      }
    }
    // the split tile is read by the async proxy (wgmma)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    const uint32_t bhi = smem_addr(phi);
    const uint32_t blo = smem_addr(plo);
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
    // while the tensor cores run: every thread is past its reads of stage s,
    // so chunk q + stages is staged into it
    if (q + g.stages < g.chunks) stage_chunk(q + g.stages, s);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_regs(part);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      fence_regs(hi[k]);
      fence_regs(lo[k]);
    }
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] += part[i];
  }

  // Epilogue: acc[4j + 2i + e] is row m0 + r0 + 8i, column 8j + 2t + e of
  // this block's BN (t = lane % 4).
  float* cz = g.c + (size_t)z * g.m * g.n;
  const bool pairs = g.n % 2 == 0;       // an aligned float2
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + r0 + 8 * i;
    if (m >= g.m) continue;
    float* crow = cz + (size_t)m * g.n;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int n = n0 + 8 * jn + 2 * (lane % 4);
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

// The ring's depth for an instantiation on this device: as many stages as
// the block's share of shared memory holds, 2..kMaxStages (0: not even 2).
// One warpgroup asks for half an SM first, so that two blocks share it.
template <int WGS, int BN>
int ring_stages(int optin, int per_sm) {
  using T = Gt<WGS, BN>;
  long long budget = optin;
  if (WGS == 1) {
    const long long half = per_sm / 2 - 1024;
    if (half < budget && (half - T::kFixedBytes) / T::kStageBytes >= 2)
      budget = half;
  }
  const long long fit = (budget - T::kFixedBytes) / T::kStageBytes;
  if (fit < 2) return 0;
  return fit < kMaxStages ? (int)fit : kMaxStages;
}

template <int WGS, int BN>
int launch(Gemm g, long long batch, int n_tiles, int device, int optin,
           int per_sm, cudaStream_t stream) {
  using T = Gt<WGS, BN>;
  static std::atomic<int> set[kMaxDevices];
  g.stages = ring_stages<WGS, BN>(optin, per_sm);
  if (!g.stages) return (int)cudaErrorInvalidValue;
  const size_t smem = T::smem(g.stages);
  cudaError_t err = raise_smem(
      reinterpret_cast<const void*>(gemm_tf32x3_lockstep<WGS, BN>), set, device,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  g.m_tiles = (g.m + T::kBM - 1) / T::kBM;
  const long long blocks = batch * g.m_tiles;
  if (blocks >= (1LL << 31) || n_tiles > 65535) return (int)cudaErrorInvalidValue;
  gemm_tf32x3_lockstep<WGS, BN>
      <<<dim3((unsigned)blocks, (unsigned)n_tiles), T::kThreads, smem, stream>>>(g);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// a: (b1, b2, m, k) at a + i1 * sa1 + i2 * sa2 + row * lda + col; b: (b1,
// b2, n, k) (kn = 0) or (b1, b2, k, n) (kn = 1) with its own strides; bias:
// (n) or null; c: (b1 * b2, m, n) contiguous, which the caller allocates.
// vec_a, vec_b: the operand's rows start 16-byte aligned and hold a multiple
// of 4 floats along their contiguous axis (16-byte copies), else 0. bm (64
// or 128) and bn (16, 32, 64 or 128): ops/gemm_tf32x3.py::gemm_plan's tile.
// Strides and extents in floats. Returns a CUDA error code.
int vft_gemm_tf32x3_lockstep(const void* a, const void* b, const void* bias, void* c,
                    int b1, int b2, int m, int n, int k, long long sa1,
                    long long sa2, int lda, long long sb1, long long sb2,
                    int ldb, int kn, int vec_a, int vec_b, float alpha,
                    int bm, int bn, void* stream) {
  if (b1 < 0 || b2 < 1 || m < 0 || n < 0 || k < 1 || lda < 1 || ldb < 1
      || sa1 < 0 || sa2 < 0 || sb1 < 0 || sb2 < 0 || (kn != 0 && kn != 1)
      || (bm != 64 && bm != 128))
    return (int)cudaErrorInvalidValue;
  if (!kn ? (lda < k || ldb < k) : (lda < k || ldb < n))
    return (int)cudaErrorInvalidValue;
  if (reinterpret_cast<uintptr_t>(c) % 8 != 0
      || (vec_a && (reinterpret_cast<uintptr_t>(a) % 16 != 0 || lda % 4 != 0
                    || sa1 % 4 != 0 || sa2 % 4 != 0 || k % 4 != 0))
      || (vec_b && (reinterpret_cast<uintptr_t>(b) % 16 != 0 || ldb % 4 != 0
                    || sb1 % 4 != 0 || sb2 % 4 != 0
                    || (kn ? n % 4 != 0 : k % 4 != 0))))
    return (int)cudaErrorMisalignedAddress;
  const long long batch = (long long)b1 * b2;
  if (batch == 0 || m == 0 || n == 0) return (int)cudaSuccess;
  const int n_tiles = (n + bn - 1) / bn;
  Gemm g{static_cast<const float*>(a), static_cast<const float*>(b),
         static_cast<const float*>(bias), static_cast<float*>(c), sa1, sa2,
         sb1, sb2, lda, ldb, m, n, k, b2, 0, kn, vec_a, vec_b, alpha,
         (k + kBK - 1) / kBK, 0};
  int device = 0, optin = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &per_sm, cudaDevAttrMaxSharedMemoryPerMultiprocessor, device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the tile widths: ops/gemm_tf32x3.py::GEMM_WIDTHS
#define VFT_GEMM_WIDTH(W)                                                    \
  case W:                                                                    \
    return bm == 128                                                         \
        ? launch<2, W>(g, batch, n_tiles, device, optin, per_sm, s)          \
        : launch<1, W>(g, batch, n_tiles, device, optin, per_sm, s);
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

}  // extern "C"
