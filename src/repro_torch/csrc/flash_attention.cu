// Flash attention for prefill on Hopper (sm_90a), bound through a plain C
// interface (ctypes, see kernels/build.py and kernels/flash_attention.py).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attention.py::flash_attention_pallas: GQA attention
// of q (B,S,H,hd) over k, v (B,S,K,hd), causal and/or sliding-window masked,
// softmax by the online (flash) recurrence with fp32 m, l and acc; p is cast
// to v's dtype before the PV product, as the TPU kernel does per tile.
//
// What bounds it: at S = 512 and hd = 64 the work is ~80 flops per byte
// moved, so on tensor cores it would be bytes; on the CUDA cores this
// kernel uses it is operations (fp32 FMAs fed from shared memory). This is
// the simple first version: no wgmma and no TMA.
//
// Design. One block per (batch, kv head, q tile). The rep = H/K query heads
// of a group share every K/V tile in shared memory, so KV is never
// replicated: a q tile holds bq = 32/rep positions x rep heads = up to 32
// query rows, four per warp. The block walks K/V tiles of 32 keys from the
// first key its rows can see (window) to the last (causal), and skips the
// rest. Inside a tile each lane owns one key for the scores (K in shared
// memory with an odd row stride, so the 32 lanes hit 32 banks) and a slice
// of head dims for the PV sum (p broadcast by warp shuffles). Any S: tails
// are masked, and nothing is padded. Fully masked keys get -1e30, as in
// the TPU kernel, so a row's state is wiped by the first tile that holds a
// key it can see.
//
// Every entry point launches on the caller's stream, allocates nothing,
// does not synchronise and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per block
constexpr int kKeys = 32;                     // keys per K/V tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// p in v's dtype, back in fp32 for the sum
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// HDV: head dims per lane, hd <= 32 * HDV.
template <typename T, int HDV>
__global__ void __launch_bounds__(kWarps * 32)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             T* __restrict__ out, int S, int H, int K, int hd, int rep, int bq, int causal,
             int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                    // kRows x hd
  float* ks = qs + kRows * hd;         // kKeys x (hd + 1)
  float* vs = ks + kKeys * (hd + 1);   // kKeys x hd
  const int g = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * bq;
  const int nq = min(bq, S - q0);
  const int rows = nq * rep;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int kstride = hd + 1;

  // q rows: row r is position q0 + r / rep of head g * rep + r % rep; the
  // rep heads of one position are adjacent in memory
  for (int i = threadIdx.x; i < kRows * hd; i += blockDim.x) {
    const int r = i / hd, d = i - r * hd;
    float x = 0.0f;
    if (r < rows) {
      const long long qi = q0 + r / rep, h = (long long)g * rep + r % rep;
      x = to_f32(q[((b * (long long)S + qi) * H + h) * hd + d]);
    }
    qs[i] = x;
  }

  // the keys any row of this tile can see
  const int last_q = q0 + nq - 1;
  const int kv_lo = window > 0 ? max(0, q0 - window + 1) : 0;
  const int kv_hi = causal ? last_q + 1 : S;

  const int r0 = warp * kRowsPerWarp;
  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][HDV];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    qpos[i] = q0 + (r0 + i) / rep;
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < HDV; ++e) acc[i][e] = 0.0f;
  }

  for (int k0 = kv_lo; k0 < kv_hi; k0 += kKeys) {
    __syncthreads();  // the previous tile is consumed (and qs is written)
    for (int i = threadIdx.x; i < kKeys * hd; i += blockDim.x) {
      const int j = i / hd, d = i - j * hd;
      const int kp = k0 + j;
      float kx = 0.0f, vx = 0.0f;
      if (kp < kv_hi) {
        const long long idx = ((b * (long long)S + kp) * K + g) * hd + d;
        kx = to_f32(k[idx]);
        vx = to_f32(v[idx]);
      }
      ks[j * kstride + d] = kx;
      vs[j * hd + d] = vx;
    }
    __syncthreads();
    if (r0 >= rows) continue;  // this warp has no live row in the tile

    // scores: lane owns key k0 + lane
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.0f;
    const float* kr = ks + lane * kstride;
    const float* qr = qs + r0 * hd;
#pragma unroll 4
    for (int d = 0; d < hd; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) s[i] += qr[i * hd + d] * kd;
    }
    const int kp = k0 + lane;
    float p[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      bool ok = kp < kv_hi;
      if (causal) ok = ok && kp <= qpos[i];
      if (window > 0) ok = ok && kp > qpos[i] - window;
      const float si = ok ? s[i] * scale : kNegInf;
      const float mn = fmaxf(m[i], warp_max(si));
      const float pi = expf(si - mn);
      const float corr = expf(m[i] - mn);
      l[i] = l[i] * corr + warp_sum(pi);
      m[i] = mn;
#pragma unroll
      for (int e = 0; e < HDV; ++e) acc[i][e] *= corr;
      p[i] = round_to<T>(pi);
    }
    // PV: lane owns head dims lane + 32 e
    for (int j = 0; j < kKeys; ++j) {
      const float* vr = vs + j * hd;
      float pj[kRowsPerWarp];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) pj[i] = __shfl_sync(0xffffffffu, p[i], j);
#pragma unroll
      for (int e = 0; e < HDV; ++e) {
        const int d = lane + 32 * e;
        if (d < hd) {
          const float vd = vr[d];
#pragma unroll
          for (int i = 0; i < kRowsPerWarp; ++i) acc[i][e] += pj[i] * vd;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    const int r = r0 + i;
    if (r >= rows) break;
    const long long qi = q0 + r / rep, h = (long long)g * rep + r % rep;
    T* o = out + ((b * (long long)S + qi) * H + h) * hd;
    const float inv_l = 1.0f / fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int e = 0; e < HDV; ++e) {
      const int d = lane + 32 * e;
      if (d < hd) o[d] = from_f32<T>(acc[i][e] * inv_l);
    }
  }
}

template <typename T, int HDV>
int launch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int K,
           int hd, int causal, int window, float scale, cudaStream_t st) {
  const int rep = H / K;
  const int bq = kRows / rep;
  const size_t smem = sizeof(float) * ((size_t)kRows * hd + (size_t)kKeys * (hd + 1) +
                                       (size_t)kKeys * hd);
  auto kernel = flash_kernel<T, HDV>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + bq - 1) / bq, K, B);
  kernel<<<grid, kWarps * 32, smem, st>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                          static_cast<const T*>(v), static_cast<T*>(out), S, H,
                                          K, hd, rep, bq, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* out, int B, int S, int H, int K,
             int hd, int causal, int window, float scale, cudaStream_t st) {
  if (hd <= 32) return launch<T, 1>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
  if (hd <= 64) return launch<T, 2>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
  if (hd <= 128) return launch<T, 4>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
  return launch<T, 8>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
}

}  // namespace

extern "C" {

// q, out: (B,S,H,hd); k, v: (B,S,K,hd); all contiguous, dtype 0 = float32 or
// 1 = bfloat16. H % K == 0 with H / K <= 32; hd a multiple of 8, at most
// 256. window <= 0 means no window. scale multiplies q.k.
int flash_attention(const void* q, const void* k, const void* v, void* out, int B, int S, int H,
                    int K, int hd, int causal, int window, float scale, int dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B <= 0 || S <= 0) return (int)cudaGetLastError();
  if (K <= 0 || H % K != 0 || H / K > kRows || hd <= 0 || hd % 8 != 0 || hd > 256)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return dispatch<float>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(q, k, v, out, B, S, H, K, hd, causal, window, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
