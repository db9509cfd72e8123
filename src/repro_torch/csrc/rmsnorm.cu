// RMSNorm for Hopper (sm_90a), bound through a plain C interface (ctypes,
// see kernels/build.py and kernels/rmsnorm.py).
//
// Replaces the Pallas TPU kernel src/repro/kernels/rmsnorm.py::rmsnorm_pallas:
// per row, x * rsqrt(mean(x^2) + eps) * scale, accumulated in fp32 and written
// in x's dtype.
//
// What bounds it: bytes. About 4 flops per element against 4 (bf16) or 8
// (fp32) bytes of traffic. The design reads each row with 16-byte vector
// loads, one warp per row: pass 1 sums the squares in fp32 and reduces them
// with warp shuffles, pass 2 re-reads the row (from L1/L2, it was just read)
// with the scale and writes the output once. Nothing else touches device
// memory. On the decoder's path the rows are few (B rows of 2048 in a decode
// step, B*S in a prefill, B*S*H head rows of hd for qk-norm), so at decode
// a launch is latency, not bandwidth.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 4;  // rows per block

__device__ __forceinline__ void load8(const float* p, float* v) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* v) {
  const uint4 r = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store8(float* p, const float* v) {
  reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
}

__device__ __forceinline__ void store8(__nv_bfloat16* p, const float* v) {
  uint4 r;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&r);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = r;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One warp per row; dim is a multiple of 8 and every row starts 16-byte
// aligned (the wrapper checks both).
template <typename TX, typename TS>
__global__ void __launch_bounds__(kWarps * 32)
rmsnorm_kernel(const TX* __restrict__ x, const TS* __restrict__ scale, TX* __restrict__ out,
               long long rows, int dim, float eps) {
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (row >= rows) return;
  const TX* xr = x + row * dim;
  TX* orow = out + row * dim;
  const int nvec = dim / 8;
  float v[8], s[8], o[8];
  float ss = 0.0f;
  for (int c = lane; c < nvec; c += 32) {
    load8(xr + c * 8, v);
#pragma unroll
    for (int i = 0; i < 8; ++i) ss += v[i] * v[i];
  }
  ss = warp_sum(ss);
  const float r = rsqrtf(ss / (float)dim + eps);
  for (int c = lane; c < nvec; c += 32) {
    load8(xr + c * 8, v);
    load8(scale + c * 8, s);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = __fmul_rn(__fmul_rn(v[i], r), s[i]);
    store8(orow + c * 8, o);
  }
}

template <typename TX, typename TS>
void launch(const void* x, const void* scale, void* out, long long rows, int dim, float eps,
            cudaStream_t st) {
  const long long blocks = (rows + kWarps - 1) / kWarps;
  rmsnorm_kernel<TX, TS><<<(unsigned)blocks, kWarps * 32, 0, st>>>(
      static_cast<const TX*>(x), static_cast<const TS*>(scale), static_cast<TX*>(out), rows,
      dim, eps);
}

}  // namespace

extern "C" {

// x, out: (rows, dim) contiguous, dtype x_dtype; scale: (dim,), dtype s_dtype
// (0 = float32, 1 = bfloat16).
int rmsnorm(const void* x, const void* scale, void* out, long long rows, int dim, float eps,
            int x_dtype, int s_dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (rows <= 0) return (int)cudaGetLastError();
  if (dim <= 0 || dim % 8 != 0) return (int)cudaErrorInvalidValue;
  if (x_dtype == 0 && s_dtype == 0) {
    launch<float, float>(x, scale, out, rows, dim, eps, st);
  } else if (x_dtype == 0 && s_dtype == 1) {
    launch<float, __nv_bfloat16>(x, scale, out, rows, dim, eps, st);
  } else if (x_dtype == 1 && s_dtype == 0) {
    launch<__nv_bfloat16, float>(x, scale, out, rows, dim, eps, st);
  } else if (x_dtype == 1 && s_dtype == 1) {
    launch<__nv_bfloat16, __nv_bfloat16>(x, scale, out, rows, dim, eps, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
