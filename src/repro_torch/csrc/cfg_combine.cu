// Guidance-combine kernels for Hopper (sm_90a), bound through a plain C
// interface (ctypes, see kernels/build.py and kernels/cfg_combine.py).
//
// Replaces the Pallas TPU kernels of src/repro/kernels/cfg_combine.py:
//   cfg_combine           <- cfg_combine_pallas           (Eq. 1, u + s*(c - u))
//   cfg_combine_rowscale  <- cfg_combine_rowscale_pallas  (Eq. 1, one s per row)
//   apg_combine           <- apg_combine_pallas           (APG, arXiv 2410.02416)
//
// What bounds them: bytes. Each does a few flops per element against 6-12
// bytes of traffic, far below the ~20 flop/byte ridge of fp32 on an H100
// (67 TFLOP/s over 3.35 TB/s). The designs therefore read every input once
// and write the output once, with 16-byte vector accesses where the
// pointers allow, no intermediate in device memory, and fp32 arithmetic on
// bf16 or fp32 storage. At the main path's size (B x 64 x 64 x 4) a launch
// moves a few hundred KB, so launch latency, not bandwidth, sets the time.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 16;  // 16 resident blocks on each of 132 SMs
constexpr float kEps = 1e-12f;        // guards zero-norm rows, as in the TPU kernel

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Eq. 1 with one rounding per operation (no contraction into an FMA), so the
// result is bit-exact against the plain PyTorch u + s * (c - u).
__device__ __forceinline__ float eq1(float u, float c, float s) {
  return __fadd_rn(u, __fmul_rn(s, __fsub_rn(c, u)));
}

// B1 and B3. A grid-stride pass over 16-byte vectors, then a scalar tail.
// ROWSCALE reads s from scales[i / feat]; the vector path is taken only when
// feat is a multiple of the vector width, so a vector never straddles rows.
template <typename T, bool ROWSCALE>
__global__ void combine_kernel(const T* __restrict__ u, const T* __restrict__ c,
                               T* __restrict__ out, const float* __restrict__ scales,
                               float scale, long long n, long long feat, bool vec) {
  constexpr int V = 16 / sizeof(T);
  const long long tid = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long nvec = vec ? n / V : 0;
  for (long long v = tid; v < nvec; v += stride) {
    const uint4 ru = reinterpret_cast<const uint4*>(u)[v];
    const uint4 rc = reinterpret_cast<const uint4*>(c)[v];
    const T* pu = reinterpret_cast<const T*>(&ru);
    const T* pc = reinterpret_cast<const T*>(&rc);
    uint4 ro;
    T* po = reinterpret_cast<T*>(&ro);
    const float s = ROWSCALE ? scales[(v * V) / feat] : scale;
#pragma unroll
    for (int k = 0; k < V; ++k) po[k] = from_f32<T>(eq1(to_f32(pu[k]), to_f32(pc[k]), s));
    reinterpret_cast<uint4*>(out)[v] = ro;
  }
  for (long long i = nvec * V + tid; i < n; i += stride) {
    const float s = ROWSCALE ? scales[i / feat] : scale;
    out[i] = from_f32<T>(eq1(to_f32(u[i]), to_f32(c[i]), s));
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// Sums a value over the block; every thread gets the total. red holds one
// float per warp.
__device__ __forceinline__ float block_sum(float x, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  x = warp_sum(x);
  if (lane == 0) red[warp] = x;
  __syncthreads();
  float t = lane < nwarps ? red[lane] : 0.0f;
  t = warp_sum(t);
  __syncthreads();  // red is reused by the next call
  return t;
}

// B2. One block per batch row. Pass 1 reads u and c (or diff) once and
// reduces |d|^2, |c|^2 and d.c in fp32; the threshold clamp then enters as
// one scalar factor k on d, and d_par = (k d.c / |c|) * c / |c|. Pass 2
// re-reads the row, which at 64 KB per row is served from L2, and writes
// c + (s - 1) * ((k d - d_par) + eta * d_par), with s the row's own scale
// when a (rows,) scale vector is given. A row with d == 0 gives
// c + (s - 1) * 0 == c exactly; an all-zero row stays finite through kEps.
// Known weakness: with B <= 4 rows only B of the 132 SMs are busy.
template <typename T>
__global__ void apg_kernel(const T* __restrict__ u, const T* __restrict__ c,
                           const float* __restrict__ diff, const float* __restrict__ scales,
                           T* __restrict__ out, long long feat, float scale_m1, float eta,
                           float threshold) {
  __shared__ float red[32];
  const long long base = blockIdx.x * feat;
  if (scales) scale_m1 = scales[blockIdx.x] - 1.0f;
  float dd = 0.0f, cc = 0.0f, dc = 0.0f;
  for (long long j = threadIdx.x; j < feat; j += blockDim.x) {
    const float cj = to_f32(c[base + j]);
    const float dj = diff ? diff[base + j] : __fsub_rn(cj, to_f32(u[base + j]));
    dd += dj * dj;
    cc += cj * cj;
    dc += dj * cj;
  }
  dd = block_sum(dd, red);
  cc = block_sum(cc, red);
  dc = block_sum(dc, red);
  const float k = threshold > 0.0f ? fminf(1.0f, threshold / fmaxf(sqrtf(dd), kEps)) : 1.0f;
  const float cn = fmaxf(sqrtf(cc), kEps);
  const float p = k * dc / cn;  // d_par = p * (c / cn)
  for (long long j = threadIdx.x; j < feat; j += blockDim.x) {
    const float cj = to_f32(c[base + j]);
    const float dj = k * (diff ? diff[base + j] : __fsub_rn(cj, to_f32(u[base + j])));
    const float dpar = p * (cj / cn);
    out[base + j] = from_f32<T>(cj + scale_m1 * ((dj - dpar) + eta * dpar));
  }
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

template <bool ROWSCALE>
int launch_combine(const void* u, const void* c, void* out, const void* scales, float scale,
                   long long n, long long feat, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int V = dtype == 0 ? 4 : 8;
  const bool vec = aligned16(u) && aligned16(c) && aligned16(out) && (!ROWSCALE || feat % V == 0);
  const long long work = vec ? n / V + n % V : n;
  const int grid = grid_for(work);
  const float* sc = static_cast<const float*>(scales);
  if (dtype == 0) {
    combine_kernel<float, ROWSCALE><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(u), static_cast<const float*>(c), static_cast<float*>(out),
        sc, scale, n, feat, vec);
  } else if (dtype == 1) {
    combine_kernel<__nv_bfloat16, ROWSCALE><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(c),
        static_cast<__nv_bfloat16*>(out), sc, scale, n, feat, vec);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (u, c and out share it).
int cfg_combine(const void* u, const void* c, void* out, long long n, float scale, int dtype,
                void* stream) {
  return launch_combine<false>(u, c, out, nullptr, scale, n, n > 0 ? n : 1, dtype, stream);
}

// scales: float32, one per row of feat elements.
int cfg_combine_rowscale(const void* u, const void* c, void* out, const void* scales,
                         long long rows, long long feat, int dtype, void* stream) {
  return launch_combine<true>(u, c, out, scales, 0.0f, rows * feat, feat, dtype, stream);
}

// diff: float32 (rows, feat) replacing c - u, or null. scales: float32
// (rows,), one guidance scale per row, or null for the one scale whose
// s - 1 is scale_m1.
int apg_combine(const void* u, const void* c, const void* diff, const void* scales, void* out,
                long long rows, long long feat, float scale_m1, float eta, float threshold,
                int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* df = static_cast<const float*>(diff);
  const float* sc = static_cast<const float*>(scales);
  if (rows <= 0) return (int)cudaGetLastError();
  if (dtype == 0) {
    apg_kernel<float><<<(unsigned)rows, kThreads, 0, st>>>(
        static_cast<const float*>(u), static_cast<const float*>(c), df, sc,
        static_cast<float*>(out), feat, scale_m1, eta, threshold);
  } else if (dtype == 1) {
    apg_kernel<__nv_bfloat16><<<(unsigned)rows, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(u), static_cast<const __nv_bfloat16*>(c), df, sc,
        static_cast<__nv_bfloat16*>(out), feat, scale_m1, eta, threshold);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernels_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
