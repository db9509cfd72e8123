// RMSNorm for Hopper (sm_90a), bound through a plain C interface (ctypes,
// see kernels/build.py and kernels/rmsnorm.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas:
// per row, x * rsqrt(mean(x^2) + eps) * scale, accumulated in fp32 and written
// in x's dtype.
//
// What bounds it: at the shapes the decoders give it, latency, not bytes. A
// decode step normalises 4 rows of 2048 bf16 (16 KB of x), a serve tick 16
// rows; the bytes bound is 0.01-0.04 us, the cost of a launch and of one
// trip to L2 is microseconds. Only the prefill's 2048 x 2048 moves enough
// (16 MB) for bandwidth to matter. So the design keeps every launch to ONE
// dependent memory round trip: each thread issues all of its x vectors and
// the matching scale elements at entry, in one wave, holds the row in
// registers, reduces the sum of squares (warp shuffles, then one
// shared-memory step across the warps of a row) and writes each output
// vector once with a 16-byte store. x is never read twice.
//
// The launch plan is rmsnorm_plan in kernels/rmsnorm.py; this entry point
// checks it. blockDim = (threads per row, rows per block); a thread holds
// VPT 16-byte vectors of x (8 bf16 or 4 float32) at vector indices
// threadIdx.x + v * threads of its row.
//   few rows (fewer than the card's 132 SMs, dim > 256): one block a row of
//     dim / 8 threads (VPT 1 for bf16, 2 for float32), so that the row is
//     spread over as many threads, and the rows over as many SMs, as can be;
//   many rows, dim > 256: one block a row again, of 16 elements a thread
//     (VPT 2 for bf16, 4 for float32). On an H100 at 256 and 2048 rows of
//     2048 this measured faster than 64 threads of 4 vectors with 4 rows a
//     block, and than a warp a row of 8 vectors a thread (timed while the
//     design was chosen; chip_smoke.py times the plan itself);
//   head rows (dim <= 256, 64-128 for qk-norm): a power-of-two sub-warp of
//     8 elements a thread a row, several rows a block, whole warps.
// Registers: at most 4 vectors of x and their scale a thread (32 words of
// data at float32/float32), so no dim up to MAX_DIM = 8192 re-reads x. A
// bulk copy into shared memory (cp.async.bulk) was not tried: the register
// route already keeps one memory round trip a launch.
//
// Arithmetic: the sum of squares in fp32 (another order than the plain
// version's), rsqrtf(ss / dim + eps), then __fmul_rn(__fmul_rn(x, r), s)
// rounded once to x's dtype.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int kMaxDim = 8192;

// N elements of T as raw 32-bit words, loaded with the widest aligned access.
template <typename T, int N>
struct Pack {
  static constexpr int kWords = N * (int)sizeof(T) / 4;  // 2, 4 or 8
  uint32_t w[kWords];
};

template <typename T, int N>
__device__ __forceinline__ void load(Pack<T, N>& r, const T* p) {
  constexpr int W = Pack<T, N>::kWords;
  if constexpr (W == 2) {
    const uint2 a = *reinterpret_cast<const uint2*>(p);
    r.w[0] = a.x; r.w[1] = a.y;
  } else {
#pragma unroll
    for (int i = 0; i < W / 4; ++i) {
      const uint4 a = reinterpret_cast<const uint4*>(p)[i];
      r.w[4 * i] = a.x; r.w[4 * i + 1] = a.y; r.w[4 * i + 2] = a.z; r.w[4 * i + 3] = a.w;
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void clear(Pack<T, N>& r) {
#pragma unroll
  for (int i = 0; i < Pack<T, N>::kWords; ++i) r.w[i] = 0u;
}

// Element i as float32: a bf16 is the upper half of its float32.
template <typename T, int N>
__device__ __forceinline__ float elem(const Pack<T, N>& r, int i) {
  if constexpr (std::is_same<T, float>::value) {
    return __uint_as_float(r.w[i]);
  } else {
    const uint32_t w = r.w[i >> 1];
    return __uint_as_float((i & 1) ? (w & 0xffff0000u) : (w << 16));
  }
}

__device__ __forceinline__ void store16(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store16(__nv_bfloat16* p, const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

// blockDim = (T threads per row, R rows per block). T is a power of two up to
// 16 (a sub-warp) or a multiple of 32, and T * R is a multiple of 32, so every
// warp is whole and a sub-warp's xor partners stay inside its row.
template <typename TX, typename TS, int VPT>
__global__ void __launch_bounds__(VPT <= 2 ? 1024 : 512)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale, TX* __restrict__ out,
               int rows, int dim, float eps) {
  constexpr int N = 16 / sizeof(TX);  // elements per 16-byte vector of x
  __shared__ float red[32];
  const int T = blockDim.x;
  const int nvec = dim / N;
  const int row = blockIdx.x * blockDim.y + threadIdx.y;
  const bool live = row < rows;
  const size_t base = (size_t)(live ? row : 0) * (size_t)dim;
  const TX* xr = x + base;

  Pack<TX, N> xv[VPT];
  Pack<TS, N> sv[VPT];
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int c = threadIdx.x + v * T;
    if (live && c < nvec) {
      load(xv[v], xr + c * N);
      load(sv[v], scale + c * N);
    } else {
      clear(xv[v]);
      clear(sv[v]);
    }
  }
  float ss = 0.0f;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const float e = elem(xv[v], i);
      ss = fmaf(e, e, ss);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    if (off < T) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  if (T > 32) {  // several warps a row: one step through shared memory
    const int lane = threadIdx.x & 31;
    const int warps = T >> 5;
    if (lane == 0) red[threadIdx.y * warps + (threadIdx.x >> 5)] = ss;
    __syncthreads();
    ss = lane < warps ? red[threadIdx.y * warps + lane] : 0.0f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, off);
  }
  const float r = rsqrtf(ss / (float)dim + eps);

  TX* orow = out + base;
#pragma unroll
  for (int v = 0; v < VPT; ++v) {
    const int c = threadIdx.x + v * T;
    if (live && c < nvec) {
      float o[N];
#pragma unroll
      for (int i = 0; i < N; ++i) o[i] = __fmul_rn(__fmul_rn(elem(xv[v], i), r), elem(sv[v], i));
      store16(orow + c * N, o);
    }
  }
}

template <typename TX, typename TS>
int launch(const void* x, const void* scale, void* out, int rows, int dim, float eps, int threads,
           int vecs, int rows_per_block, cudaStream_t st) {
  const dim3 block(threads, rows_per_block);
  const unsigned grid = (unsigned)((rows + rows_per_block - 1) / rows_per_block);
  const TX* xp = static_cast<const TX*>(x);
  const TS* sp = static_cast<const TS*>(scale);
  TX* op = static_cast<TX*>(out);
  switch (vecs) {
    case 1: rmsnorm_kernel<TX, TS, 1><<<grid, block, 0, st>>>(xp, sp, op, rows, dim, eps); break;
    case 2: rmsnorm_kernel<TX, TS, 2><<<grid, block, 0, st>>>(xp, sp, op, rows, dim, eps); break;
    case 4: rmsnorm_kernel<TX, TS, 4><<<grid, block, 0, st>>>(xp, sp, op, rows, dim, eps); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// The plan's invariants (kernels/rmsnorm.py::rmsnorm_plan).
bool plan_ok(int dim, int x_dtype, int threads, int vecs, int rows_per_block) {
  const int nvec = dim / (x_dtype == 0 ? 4 : 8);
  const int block = threads * rows_per_block;
  const bool warp_multiple = threads % 32 == 0;
  const bool sub_warp = threads < 32 && (threads & (threads - 1)) == 0;
  return (vecs == 1 || vecs == 2 || vecs == 4) && rows_per_block >= 1 &&
         (warp_multiple || sub_warp) && block % 32 == 0 &&
         block <= (vecs <= 2 ? 1024 : 512) && threads * vecs >= nvec;
}

}  // namespace

extern "C" {

// x, out: (rows, dim) contiguous, dtype x_dtype; scale: (dim,), dtype s_dtype
// (0 = float32, 1 = bfloat16); all 16-byte aligned. threads (per row), vecs
// (16-byte vectors of x a thread) and rows_per_block: the launch plan.
int rmsnorm(const void* x, const void* scale, void* out, long long rows, int dim, float eps,
            int x_dtype, int s_dtype, int threads, int vecs, int rows_per_block, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return (int)cudaGetLastError();
  if (rows > 0x7fffffffLL || dim <= 0 || dim % 8 != 0 || dim > kMaxDim ||
      !plan_ok(dim, x_dtype, threads, vecs, rows_per_block))
    return (int)cudaErrorInvalidValue;
  const int r = (int)rows;
  if (x_dtype == 0 && s_dtype == 0)
    return launch<float, float>(x, scale, out, r, dim, eps, threads, vecs, rows_per_block, st);
  if (x_dtype == 0 && s_dtype == 1)
    return launch<float, __nv_bfloat16>(x, scale, out, r, dim, eps, threads, vecs,
                                        rows_per_block, st);
  if (x_dtype == 1 && s_dtype == 0)
    return launch<__nv_bfloat16, float>(x, scale, out, r, dim, eps, threads, vecs,
                                        rows_per_block, st);
  if (x_dtype == 1 && s_dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, r, dim, eps, threads, vecs,
                                                rows_per_block, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
