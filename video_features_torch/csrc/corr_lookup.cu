// RAFT correlation-window lookup for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of video_features_tpu/ops/pallas_corr.py:
//   * vft_corr_lookup_masked  <- lookup_corr_lanes (_lanes_kernel)
//   * vft_corr_lookup_padded  <- lookup_corr (_level_kernel)
//
// Both compute, for each of N pixels and each of the 4 pyramid levels
// (coords scaled by 2^-l), the (2r+1)^2 = 81 bilinear samples of that pixel's
// own correlation map around (x, y), zeros outside the map
// (grid_sample align_corners=True, padding_mode='zeros'). Output element
// l*81 + i*9 + j samples (x + i - r, y + j - r): the reference's dy-major
// order. The output is (N, 324) float32, the layout RAFT's motion encoder
// reads, written once.
//
// Levels are in their natural (N, h, w) layout (the TPU kernels' (h, w, N')
// lane transpose, 128-lane padding and one-hot-matmul "slice" are artifacts
// of the TPU's tiling). The masked kernel reads the plain levels; the padded
// kernel reads levels zero-padded by PAD = 2r+3 on every side (done once per
// RAFT forward, outside the iteration loop) with coordinates clamped so that
// every read is in bounds.
//
// What bounds it on the H100: bytes. Per pixel it writes 324 floats (1296 B)
// and reads one (2r+2)^2 = 10x10 patch per level, 9 flops per output. At the
// main path's batch-8 shape (N = 176,128) that is 228 MB written and at most
// 282 MB of patch cells read. Each 40-byte patch row touches 2-3 32-byte
// sectors, so the reads cost 1.7-2x the cells' bytes; the scattered sector
// reads, not the stores, are what the time goes to.
//
// Design. A block owns groups of kPixels consecutive pixels and loops over
// them (grid-stride, the grid sized by the occupancy calculator to fill every
// SM), with kStages (3) slots in shared memory, so two groups' copies are in
// flight while a third blends (51 KB of dynamic shared memory a block, set
// with cudaFuncSetAttribute; 4 blocks per SM):
//   1. Stage: warp w < kPixels takes pixel w of the group. It loads the
//      pixel's coordinates once and, per level, computes once the scale, the
//      clamp, the floors and the fractional weights (warp-uniform), then
//      copies the level's 10x10 patch row by row into shared memory with
//      4-byte cp.async, neighbouring lanes on neighbouring x. The masked
//      kernel gives cp.async a src-size of 0 for cells outside the map,
//      which zero-fills them: the zeros padding is in the copy and the blend
//      has no predicates. The padded kernel copies its padded level unmasked.
//      The coordinates of the group after this one are loaded while it is
//      staged, and the next groups' copies are in flight (commit_group /
//      wait_group) while one blends.
//   2. Blend: thread u (288 = kPixels x 4 levels x 9 x-offsets) reads two
//      patch columns (20 shared loads) and writes 9 outputs (one y column of
//      the window) to an output tile in shared memory. Patches sit 105
//      floats apart (105 = 9 mod 32) and a patch row is 10 floats, so the
//      warp's reads and its stride-9 writes are free of bank conflicts.
//      The masked kernel blends x first, then y (the TPU lanes kernel's
//      order); the padded kernel takes the 4-term blend of the TPU
//      window-slice kernel with weights computed once per (pixel, level).
//   3. Store: the group's kPixels x 1296 bytes leave as one contiguous run
//      of 16-byte streaming stores (st.global.cs: the motion encoder reads
//      the output once, later). A ragged last group is masked.
// No thread divides by 324, 81 or 9 per output: every thread's copy cells
// and blend unit are fixed at its start.
//
// Why not TMA: a tensor map needs row strides that are multiples of 16
// bytes; the levels' rows are 172 / 84 / 40 / 20 bytes (w = 43, 21, 10, 5),
// padded 260 / 172 / 128 / 108, and a 1-D bulk copy needs 16-byte aligned
// 16-byte multiples, which a 40-byte row at any 4-byte offset is not. Why
// not tensor cores: 9 flops per output against 4+ bytes moved; the kernel is
// bound by bytes, not by operations.
//
// Each entry point launches on the given stream, does not synchronize, and
// returns cudaGetLastError() so the caller can raise on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kLevels = 4;
constexpr int kRadius = 4;
constexpr int kSide = 2 * kRadius + 1;        // 9
constexpr int kWindow = kSide * kSide;        // 81
constexpr int kOut = kLevels * kWindow;       // 324
constexpr int kPad = 2 * kRadius + 3;         // 11
constexpr int kPatch = kSide + 1;             // 10: the patch's side
constexpr int kPatchCells = kPatch * kPatch;  // 100
constexpr int kPatchStride = 105;             // = 9 (mod 32): conflict-free blend
constexpr int kPixels = 8;                    // pixels per group
constexpr int kPatches = kPixels * kLevels;   // 32 per group
constexpr int kThreads = kPatches * kSide;    // 288: one blend unit each
constexpr int kCopyRounds = (kPatchCells + 31) / 32;   // 4 cp.async per patch
constexpr int kStages = 3;                    // groups in flight + 1 blending
constexpr int kMinBlocks = 4;                 // resident blocks per SM

static_assert(kStages >= 2, "at least one group in flight while one blends");

static_assert(kThreads / 32 >= kPixels, "one staging warp per pixel");
static_assert(kOut % 4 == 0, "a pixel's output row is whole float4s");

struct Levels {
  const float* ptr[kLevels];
  int h[kLevels];
  int w[kLevels];
};

struct __align__(16) Smem {
  float4 weights[kStages][kPatches];           // masked: (fx, fy); padded: 4 terms
  float out[kPixels * kOut];                   // the group's output rows
  float patch[kStages][kPatches * kPatchStride];
};

// Clamp a coordinate to [-r-2, extent+r+1]. Any coordinate beyond that range
// has every sample of its window at least one pixel outside the map, so the
// window is all zeros either way; the clamp keeps the float->int conversion
// in range and every padded read in bounds.
__device__ __forceinline__ float clamp_coord(float v, int extent) {
  return fminf(fmaxf(v, -kRadius - 2.0f), extent + kRadius + 1.0f);
}

// 4-byte asynchronous copy global -> shared; src_bytes 0 zero-fills dst
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          unsigned src_bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(kPending) : "memory");
}

// One warp stages pixel p's four patches and their blend weights.
template <bool kPadded>
__device__ __forceinline__ void stage_pixel(const Levels& lv, int64_t p,
                                            float cx, float cy, float* patch,
                                            float4* weights, int lane,
                                            const int (&row)[kCopyRounds],
                                            const int (&col)[kCopyRounds]) {
#pragma unroll
  for (int l = 0; l < kLevels; ++l) {
    const int h = lv.h[l];
    const int w = lv.w[l];
    const float scale = 1.0f / (float)(1 << l);   // exact power of two
    const float x = clamp_coord(cx * scale, w);
    const float y = clamp_coord(cy * scale, h);
    const float x0 = floorf(x);
    const float y0 = floorf(y);
    const float fx = x - x0;
    const float fy = y - y0;
    const int gx = (int)x0 - kRadius;             // the patch's corner
    const int gy = (int)y0 - kRadius;
    float* dst = patch + l * kPatchStride + lane;
    if (lane == 0) {
      weights[l] = kPadded
          ? make_float4((1.0f - fx) * (1.0f - fy), fx * (1.0f - fy),
                        (1.0f - fx) * fy, fx * fy)
          : make_float4(fx, fy, 0.0f, 0.0f);
    }
    if (kPadded) {
      // in bounds by the clamp: columns gx + kPad .. gx + kPad + 9 lie in
      // [1, w + 2 * kPad - 1], rows likewise
      const int wp = w + 2 * kPad;
      const float* src = lv.ptr[l] + p * (int64_t)(h + 2 * kPad) * wp
                       + (int64_t)(gy + kPad) * wp + gx + kPad;
#pragma unroll
      for (int k = 0; k < kCopyRounds; ++k) {
        if (lane + 32 * k < kPatchCells)
          cp_async4(dst + 32 * k, src + row[k] * wp + col[k], 4u);
      }
    } else {
      const float* map = lv.ptr[l] + p * (int64_t)h * w;
#pragma unroll
      for (int k = 0; k < kCopyRounds; ++k) {
        if (lane + 32 * k < kPatchCells) {
          const int yy = gy + row[k];
          const int xx = gx + col[k];
          const bool in = (unsigned)yy < (unsigned)h && (unsigned)xx < (unsigned)w;
          cp_async4(dst + 32 * k, in ? map + yy * w + xx : map, in ? 4u : 0u);
        }
      }
    }
  }
}

// One blend unit: x offset i of one (pixel, level) -> its 9 outputs (one y
// column of the window). `column` points at patch column i.
template <bool kPadded>
__device__ __forceinline__ void blend_unit(const float* column, float4 wt,
                                           float* out) {
  float a[kPatch], b[kPatch];                    // columns i and i + 1
#pragma unroll
  for (int r = 0; r < kPatch; ++r) {
    a[r] = column[r * kPatch];
    b[r] = column[r * kPatch + 1];
  }
  if (kPadded) {
    // the 4-term blend of the TPU window-slice kernel
#pragma unroll
    for (int j = 0; j < kSide; ++j)
      out[j] = wt.x * a[j] + wt.y * b[j] + wt.z * a[j + 1] + wt.w * b[j + 1];
  } else {
    // x blend first, then y: the order of the TPU lanes kernel
    float t[kPatch];
#pragma unroll
    for (int r = 0; r < kPatch; ++r) t[r] = (1.0f - wt.x) * a[r] + wt.x * b[r];
#pragma unroll
    for (int j = 0; j < kSide; ++j)
      out[j] = (1.0f - wt.y) * t[j] + wt.y * t[j + 1];
  }
}

template <bool kPadded>
__device__ __forceinline__ void lookup(Smem& s, const Levels& lv,
                                       const float* __restrict__ coords,
                                       float* __restrict__ out, int64_t n) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const bool stager = warp < kPixels;
  const int64_t groups = (n + kPixels - 1) / kPixels;
  const int64_t stride = gridDim.x;

  // fixed per thread: its copy cells (row, col) and its blend unit
  int row[kCopyRounds], col[kCopyRounds];
#pragma unroll
  for (int k = 0; k < kCopyRounds; ++k) {
    row[k] = (lane + 32 * k) / kPatch;
    col[k] = (lane + 32 * k) - row[k] * kPatch;
  }
  const int unit_patch = tid / kSide;            // pixel * 4 + level
  const int unit_x = tid - unit_patch * kSide;
  const int unit_pixel = unit_patch / kLevels;

  // the staging warp's pixel coordinates, one group ahead of the copies
  float cx = 0.0f, cy = 0.0f;
  auto load_coords = [&](int64_t g) {
    const int64_t p = g * kPixels + warp;
    if (stager && g < groups && p < n) {
      cx = __ldg(coords + 2 * p);
      cy = __ldg(coords + 2 * p + 1);
    }
  };
  auto stage = [&](int64_t g, int st) {
    const int64_t p = g * kPixels + warp;
    if (stager && p < n)
      stage_pixel<kPadded>(lv, p, cx, cy, s.patch[st] + warp * kLevels * kPatchStride,
                           s.weights[st] + warp * kLevels, lane, row, col);
  };

  // prologue: the first kStages - 1 groups in flight
  int64_t g = blockIdx.x;
  int64_t next = g;                  // the next group to stage
  load_coords(next);
  for (int st = 0; st < kStages - 1; ++st, next += stride) {
    if (next < groups) stage(next, st);
    cp_async_commit();
    load_coords(next + stride);
  }
  // group g blends from slot st while `next` fills slot st_next, the one
  // the previous iteration blended
  for (int st = 0, st_next = kStages - 1; g < groups; g += stride) {
    if (next < groups) stage(next, st_next);
    cp_async_commit();
    next += stride;
    load_coords(next);
    cp_async_wait<kStages - 1>();    // this thread's copies of group g landed
    __syncthreads();                 // everyone's, and the weights

    const int64_t base = g * kPixels;
    if (base + unit_pixel < n)
      blend_unit<kPadded>(s.patch[st] + unit_patch * kPatchStride + unit_x,
                          s.weights[st][unit_patch], s.out + tid * kSide);
    __syncthreads();

    const int vecs = (int)(n - base < kPixels ? n - base : kPixels) * (kOut / 4);
    float4* dst = reinterpret_cast<float4*>(out + base * kOut);
    const float4* src = reinterpret_cast<const float4*>(s.out);
    for (int v = tid; v < vecs; v += kThreads) {
      __stcs(dst + v, src[v]);
    }
    st = st + 1 == kStages ? 0 : st + 1;
    st_next = st_next + 1 == kStages ? 0 : st_next + 1;
  }
  cp_async_wait<0>();
}

// Shared memory is dynamic: with three stages it passes the 48 KB that a
// static allocation may take.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
masked_kernel(Levels lv, const float* __restrict__ coords,
              float* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  lookup<false>(*reinterpret_cast<Smem*>(smem), lv, coords, out, n);
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
padded_kernel(Levels lv, const float* __restrict__ coords,
              float* __restrict__ out, int64_t n) {
  extern __shared__ __align__(16) unsigned char smem[];
  lookup<true>(*reinterpret_cast<Smem*>(smem), lv, coords, out, n);
}

Levels make_levels(const void* l0, const void* l1, const void* l2,
                   const void* l3, int h0, int w0, int h1, int w1, int h2,
                   int w2, int h3, int w3) {
  Levels lv;
  lv.ptr[0] = static_cast<const float*>(l0);
  lv.ptr[1] = static_cast<const float*>(l1);
  lv.ptr[2] = static_cast<const float*>(l2);
  lv.ptr[3] = static_cast<const float*>(l3);
  lv.h[0] = h0; lv.w[0] = w0;
  lv.h[1] = h1; lv.w[1] = w1;
  lv.h[2] = h2; lv.w[2] = w2;
  lv.h[3] = h3; lv.w[3] = w3;
  return lv;
}

using Kernel = void (*)(Levels, const float*, float*, int64_t);

// Resident blocks per SM for `kernel`, with the shared-memory carveout at its
// maximum (and the dynamic allowance raised where sizeof(Smem) passes 48 KB);
// 0 if the runtime refuses.
int blocks_per_sm(Kernel kernel) {
  if (sizeof(Smem) > 48 * 1024
      && cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)sizeof(Smem)) != cudaSuccess)
    return 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                           cudaSharedmemCarveoutMaxShared) != cudaSuccess)
    return 0;
  int blocks = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads,
                                                    sizeof(Smem)) != cudaSuccess)
    return 0;
  return blocks;
}

// The runtime keeps a function's attributes per device context, so the
// allowance above is set, and the occupancy it gives cached, once per device
// ordinal: a value cached once per process would leave a second card at the
// 48 KB default, where the launch fails with cudaErrorInvalidValue. A failed
// query caches nothing (0), so the next launch on that device asks again.
constexpr int kMaxDevices = 64;

int blocks_per_sm_here(Kernel kernel, std::atomic<int>* table) {
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0
      || device >= kMaxDevices)
    return 0;
  int per_sm = table[device].load(std::memory_order_acquire);
  if (per_sm == 0) {
    per_sm = blocks_per_sm(kernel);
    table[device].store(per_sm, std::memory_order_release);
  }
  return per_sm;
}

int launch(Kernel kernel, int per_sm, const void* l0, const void* l1,
           const void* l2, const void* l3, int h0, int w0, int h1, int w1,
           int h2, int w2, int h3, int w3, const void* coords, void* out,
           long long n, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (per_sm <= 0) {                    // the occupancy query failed or gave 0
    const cudaError_t err = cudaGetLastError();
    return (int)(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
    return (int)cudaErrorMisalignedAddress;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  const long long groups = (n + kPixels - 1) / kPixels;
  const long long resident = (long long)sms * per_sm;
  const unsigned blocks = (unsigned)(groups < resident ? groups : resident);
  const Levels lv = make_levels(l0, l1, l2, l3, h0, w0, h1, w1, h2, w2, h3, w3);
  kernel<<<blocks, kThreads, sizeof(Smem), (cudaStream_t)stream>>>(
      lv, static_cast<const float*>(coords), static_cast<float*>(out), n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int vft_corr_lookup_masked(const void* l0, const void* l1, const void* l2,
                           const void* l3, int h0, int w0, int h1, int w1,
                           int h2, int w2, int h3, int w3, const void* coords,
                           void* out, long long n, void* stream) {
  static std::atomic<int> per_sm[kMaxDevices];
  return launch(masked_kernel, blocks_per_sm_here(masked_kernel, per_sm), l0, l1, l2, l3, h0, w0, h1, w1, h2, w2,
                h3, w3, coords, out, n, stream);
}

int vft_corr_lookup_padded(const void* l0, const void* l1, const void* l2,
                           const void* l3, int h0, int w0, int h1, int w1,
                           int h2, int w2, int h3, int w3, const void* coords,
                           void* out, long long n, void* stream) {
  static std::atomic<int> per_sm[kMaxDevices];
  return launch(padded_kernel, blocks_per_sm_here(padded_kernel, per_sm), l0, l1, l2, l3, h0, w0, h1, w1, h2, w2,
                h3, w3, coords, out, n, stream);
}

}  // extern "C"
